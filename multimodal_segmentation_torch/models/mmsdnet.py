"""MMSDNet: a private anatomy encoder for each modality, the TPS fuser, the
VAE modality encoder, the segmentor, the FiLM or SPADE decoder and the
mask discriminator; the 18-output generator loss, the separately trained
Z-regressor and the mask discriminator's loss, and the `predict_mask`
fusion API.

Port of multimodal_segmentation_tpu/models/mmsdnet.py (components :44-77,
gen_loss :164-270, the Z-regressor :272-298, d_mask_loss :300-332,
predict_mask :334-351). Public functions take NHWC tensors; the
components run NCHW. Batch stacking is interleaved (ops/batching.py):
one call serves what the reference ran several times, with grouped
BatchNorm keeping per-invocation statistics where a component has it.

Two calls are stacked further than the JAX package stacks them, both
value-exact: the Z-regressor's two fusion directions run as one fuser
call (the fuser has no BatchNorm), and so do its six decodes and
re-encodes (the decoder and the modality encoder are per-sample). The
mask discriminator's fake pool selects its slots among the anatomies
before the eval-mode segmentor, which is per-sample, as DAFNet's pools do
(models/dafnet.py:506-594).
"""

import torch
from torch import nn

from multimodal_segmentation_torch import losses
from multimodal_segmentation_torch.models.base import (
    MaskPredictor,
    MeshMember,
    subsample_pool,
)
from multimodal_segmentation_torch.nn import (
    AnatomyEncoder,
    AnatomyFuser,
    Decoder,
    Discriminator,
    ModalityEncoder,
    Segmentor,
)
from multimodal_segmentation_torch.nn.blocks import flax_init_
from multimodal_segmentation_torch.ops.batching import batch_deinterleave as split
from multimodal_segmentation_torch.ops.batching import batch_interleave as cat


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class MMSDNet(MeshMember, MaskPredictor, nn.Module):
    """The seven MMSDNet components, initialised from `generator` as Flax
    initialises them. train() / eval() select batch or running BatchNorm
    statistics, as the JAX package's train flag does."""

    GEN_COMPONENTS = ("enc_anatomy1", "enc_anatomy2", "fuser", "enc_modality", "segmentor",
                      "decoder")
    DISC_COMPONENTS = ("d_mask",)
    ZREG_COMPONENTS = ("decoder", "enc_modality")

    def __init__(self, conf, generator=None):
        super().__init__()
        self.conf = conf
        ae = conf.anatomy_encoder
        dtype = getattr(torch, conf.compute_dtype)
        in_ch = conf.input_shape[-1]
        sc = ae.out_channels
        self.modalities = list(conf.modality)
        for name in ("enc_anatomy1", "enc_anatomy2"):
            self.add_module(name, AnatomyEncoder(
                in_ch=in_ch, filters=ae.filters, downsample=ae.downsample, norm=ae.normalise,
                out_channels=sc, rounding=ae.rounding, dtype=dtype, remat=conf.remat_convs))
        self.fuser = AnatomyFuser(
            sc, conf.input_hw, dtype=dtype,
            eval_blend_bf16=conf.eval_warp == "bf16",
        )
        self.enc_modality = ModalityEncoder(sc + in_ch, conf.input_hw, conf.num_z, dtype)
        self.segmentor = Segmentor(sc, conf.num_masks, dtype=dtype, remat=conf.remat_convs)
        self.decoder = Decoder(conf.decoder_type, sc, conf.num_z, dtype, conf.input_hw)
        dm = conf.d_mask_params
        self.d_mask = Discriminator(conf.num_masks, conf.input_hw, dm.filters,
                                    dm.downsample_blocks, dtype)
        flax_init_(self, generator)

    def component_parameters(self, names):
        return [p for n in names for p in getattr(self, n).parameters()]

    def encode_anatomies(self, x1, x2):
        """Both modalities' anatomies, NCHW, each through its own encoder."""
        return self.enc_anatomy1(x1), self.enc_anatomy2(x2)

    # --------------------------------------------------------- generator loss

    def gen_loss(self, batch, gen_eps, supervised):
        """The 18-output trainer's loss (models/mmsdnet.py:164-270; targets
        from the reference's mmsdnet_executor.py:242-306).

        Args:
          batch: NHWC tensors x1, x2 (B, H, W, 1); m1 and, when supervised,
            m2 (B, H, W, num_masks + 1) with the residual channel.
          gen_eps: (6B, num_z) reparameterisation noise of the one VAE call
            over the six anatomies, in its interleaved order [s1, s2,
            s1_def, s1_fused, s2_def, s2_fused].
          supervised: whether m2 is labelled.

        Returns:
          (total, metrics): supervised_Mask, adv_M, rec_X, KL and loss. In
          train mode both encoders' and the segmentor's running statistics
          are updated on the way.
        """
        conf = self.conf
        nm = conf.num_masks
        x1, x2 = _nchw(batch["x1"]), _nchw(batch["x2"])
        s1, s2 = self.encode_anatomies(x1, x2)
        # both fusion directions in one LocNet/warp call
        s_def, s_fused = self.fuser(cat([s1, s2]), cat([s2, s1]))
        s1_def, s2_def = split(s_def, 2)
        s1_fused, s2_fused = split(s_fused, 2)
        # all six modality encodings in one VAE call; the s1-derived
        # anatomies pair with x2 (mmsdnet.py:117-124)
        s_all = cat([s1, s2, s1_def, s1_fused, s2_def, s2_fused])
        x_pair = cat([x1, x2, x2, x2, x1, x1])
        z_all, _, _, kl_all = self.enc_modality(s_all, x_pair, gen_eps)
        # all six segmentations in one call, per-map BatchNorm statistics
        ms = split(_nhwc(self.segmentor(s_all, groups=6)), 6)
        # all six reconstructions in one decoder call
        ys = split(self.decoder(s_all, z_all), 6)

        m1_t = batch["m1"]
        if supervised:
            m2_t = batch["m2"]
            # targets [m1, m2, m2, m2, m1, m1] (mmsdnet_executor.py:185-189)
            seg_pairs = [(m1_t, ms[0]), (m2_t, ms[1]), (m2_t, ms[2]), (m2_t, ms[3]),
                         (m1_t, ms[4]), (m1_t, ms[5])]
        else:
            # only modality 1 has masks (mmsdnet.py:107-116, 136-144)
            seg_pairs = [(m1_t, ms[0]), (m1_t, ms[4]), (m1_t, ms[5])]
        seg = sum(losses.restricted_dice_loss(t, p, nm) for t, p in seg_pairs)
        # one discriminator call over all six masks
        adv_all, _ = self.d_mask(_nchw(cat([m[..., :nm] for m in ms])))
        adv_m = sum(losses.lsgan_fool(a) for a in split(adv_all, 6))
        rec = sum(losses.mae(t, p) for t, p in zip((x1, x2, x2, x2, x1, x1), ys))
        kl = sum(losses.ypred_loss(k) for k in split(kl_all, 6))
        total = conf.w_sup_M * seg + conf.w_adv_M * adv_m + conf.w_rec_X * rec + conf.w_kl * kl
        metrics = {"supervised_Mask": seg, "adv_M": adv_m, "rec_X": rec, "KL": kl,
                   "loss": total}
        return total, metrics

    # ------------------------------------------------------------ Z-regressor

    @torch.no_grad()
    def make_z_regressor_anatomies(self, x1, x2):
        """The six anatomies the Z-regressor trains on, NCHW and detached:
        s1, s2, s1_def, s1_fused, s2_def, s2_fused (mmsdnet.py:272-283).
        Call it in eval mode (running BatchNorm statistics); both fusion
        directions run as one fuser call. x1, x2: NHWC (B, H, W, 1)."""
        s1, s2 = self.encode_anatomies(_nchw(x1), _nchw(x2))
        s_def, s_fused = self.fuser(cat([s1, s2]), cat([s2, s1]))
        s1_def, s2_def = split(s_def, 2)
        s1_fused, s2_fused = split(s_fused, 2)
        return [s1, s2, s1_def, s1_fused, s2_def, s2_fused]

    def z_regressor_loss(self, s_list, z_list):
        """w_rec_Z * sum_i mae(z_i, Enc_Modality_mu(s_i, Decoder(s_i, z_i)))
        over the six (anatomy, z) pairs (mmsdnet.py:285-298), the six
        decodes and re-encodes each in one call. Returns (total,
        {'rec_Z': total})."""
        s = cat(s_list)
        y = self.decoder(s, cat(z_list))
        _, mu, _, _ = self.enc_modality(s, y)
        total = sum(losses.mae(z, m) for z, m in zip(z_list, split(mu, len(s_list))))
        total = self.conf.w_rec_Z * total
        return total, {"rec_Z": total}

    # ---------------------------------------------------- discriminator loss

    @torch.no_grad()
    def make_fake_masks(self, x1, x2, pool_idx):
        """The mask discriminator's fake pool (mmsdnet.py:300-324), from the
        generator as it stands; call it in eval mode. Slot b is the
        segmentation of variant pool_idx[b] of [s1, s2, s1_def, s1_fused]
        (the simple segmentations of both modalities, modality 1's deformed
        and fused ones), selected before the per-sample segmentor.

        x1, x2: NHWC (B, H, W, 1); pool_idx: (B,) slots in {0, 1, 2, 3}.
        Returns NHWC (B, H, W, num_masks), detached."""
        s1, s2 = self.encode_anatomies(_nchw(x1), _nchw(x2))
        s1_def, s1_fused = self.fuser(s1, s2)
        sel = subsample_pool(pool_idx, [s1, s2, s1_def, s1_fused])
        return _nhwc(self.segmentor(sel))[..., : self.conf.num_masks]

    def d_mask_loss(self, real_m, fake_m):
        """LSGAN real/fake loss plus the spectral penalty of the mask
        discriminator (mmsdnet.py:326-332), real and fake scored in one
        call (no norm layers: the scores are those of two calls). Updates
        d_mask's `u`. real_m, fake_m: NHWC (B, H, W, num_masks)."""
        d_all, penalty = self.d_mask(_nchw(cat([real_m, fake_m.detach()])),
                                     collect_spectral=True)
        loss = losses.lsgan_disc(*split(d_all, 2)) + penalty
        return loss, {"dis_M": loss}
