"""DAFNet: dual anatomy encoder, TPS fuser, VAE modality encoder,
segmentor, FiLM decoder, balancer and the three spectral-norm
discriminators; the expert-pairing training losses and the `predict_mask`
fusion API.

Port of multimodal_segmentation_tpu/models/dafnet.py (components :49-100,
gen_loss_expert :191-311, fake pools :506-594, discriminator losses
:596-653, predict_mask :657-685). Public functions take NHWC tensors; the
components run NCHW. Batch stacking is interleaved (ops/batching.py), so
one call serves what the reference ran several times, with grouped
BatchNorm keeping per-invocation statistics. Automated pairing is still
to be ported (ROADMAP.md, queue A).
"""

import torch
from torch import nn

from multimodal_segmentation_torch import losses
from multimodal_segmentation_torch.models.base import subsample_pool
from multimodal_segmentation_torch.nn import (
    AnatomyFuser,
    Balancer,
    Decoder,
    Discriminator,
    DualAnatomyEncoder,
    ModalityEncoder,
    Segmentor,
)
from multimodal_segmentation_torch.nn.blocks import flax_init_
from multimodal_segmentation_torch.ops.batching import batch_deinterleave as split
from multimodal_segmentation_torch.ops.batching import batch_interleave as cat

FUSION_TYPES = ("simple", "def", "max", "maxnostn")


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def resolve_device(device):
    """torch.device for `device`; 'cuda' without an index means the current
    card. Raises when CUDA is asked for and there is none: nothing here
    moves to the CPU unless the caller says device='cpu'."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class DAFNet(nn.Module):
    """The nine DAFNet components, initialised from `generator` as Flax
    initialises them. train() / eval() select batch or running BatchNorm
    statistics, as the JAX package's train flag does."""

    GEN_COMPONENTS = ("enc_anatomy", "fuser", "enc_modality", "segmentor",
                      "decoder", "balancer")
    DISC_COMPONENTS = ("d_mask", "d_image1", "d_image2")

    def __init__(self, conf, generator=None):
        super().__init__()
        self.conf = conf
        ae = conf.anatomy_encoder
        dtype = getattr(torch, conf.compute_dtype)
        in_ch = conf.input_shape[-1]
        sc = ae.out_channels
        self.modalities = list(conf.modality)
        self.enc_anatomy = DualAnatomyEncoder(
            in_ch=in_ch,
            filters=ae.filters,
            downsample=ae.downsample,
            norm=ae.normalise,
            out_channels=sc,
            rounding=ae.rounding,
            dtype=dtype,
        )
        self.fuser = AnatomyFuser(
            sc, conf.input_hw, dtype=dtype,
            eval_blend_bf16=conf.eval_warp == "bf16",
        )
        self.enc_modality = ModalityEncoder(sc + in_ch, conf.input_hw, conf.num_z, dtype)
        self.segmentor = Segmentor(sc, conf.num_masks, dtype=dtype)
        self.decoder = Decoder(conf.decoder_type, sc, conf.num_z, dtype)
        self.balancer = Balancer(conf.n_pairs)
        dm, di = conf.d_mask_params, conf.d_image_params
        self.d_mask = Discriminator(conf.num_masks, conf.input_hw, dm.filters,
                                    dm.downsample_blocks, dtype)
        self.d_image1 = Discriminator(in_ch, conf.input_hw, di.filters,
                                      di.downsample_blocks, dtype)
        self.d_image2 = Discriminator(in_ch, conf.input_hw, di.filters,
                                      di.downsample_blocks, dtype)
        flax_init_(self, generator)

    def component_parameters(self, names):
        return [p for n in names for p in getattr(self, n).parameters()]

    # ------------------------------------------------------ expert-pair loss

    def gen_loss_expert(self, batch, gen_eps, supervised):
        """Generator loss for expert pairing (models/dafnet.py:191-311).

        Args:
          batch: NHWC tensors x1, x2 (B, H, W, 1); m1 and, when supervised,
            m2 (B, H, W, num_masks + 1) with the residual channel; z1, z2
            (B, num_z) sampled N(0, 1).
          gen_eps: (2B, num_z) reparameterisation noise of the modality
            encoder, in the interleaved [x1, x2] order.
          supervised: whether m2 is labelled.

        Returns:
          (total, metrics): the scalar loss and a dict of scalar tensors.
          In train mode the anatomy encoder's and the segmentor's running
          statistics are updated on the way.
        """
        conf = self.conf
        nm = conf.num_masks
        x1, x2 = _nchw(batch["x1"]), _nchw(batch["x2"])
        z1_in, z2_in = batch["z1"], batch["z2"]

        s1, s2 = self.enc_anatomy(x1, x2)
        # both fusion directions in one LocNet/warp call
        s_def, _ = self.fuser(cat([s1, s2]), cat([s2, s1]))
        s1_def, s2_def = split(s_def, 2)
        # modality VAE over both modalities at once
        z, _, _, kl = self.enc_modality(cat([s1, s2]), cat([x1, x2]), gen_eps)
        z1, z2 = split(z, 2)
        kl1, kl2 = split(kl, 2)
        # all four segmentations in one call, per-map BatchNorm statistics
        m = _nhwc(self.segmentor(cat([s1, s2, s2_def, s1_def]), groups=4))
        m1, m2, m1_s2_def, m2_s1_def = split(m, 4)
        # all six decodes in one call (FiLM is per-sample)
        y = self.decoder(cat([s1, s2, s2_def, s1_def, s1, s2]),
                         cat([z1, z2, z1, z2, z1_in, z2_in]))
        y1, y2, y1_s2_def, y2_s1_def, y1_zin, y2_zin = split(y, 6)
        # adversarial forwards, one call per discriminator
        adv_m, _ = self.d_mask(_nchw(cat([m1, m2, m1_s2_def, m2_s1_def])[..., :nm]))
        adv_m1, adv_m2, adv_m1_def, adv_m2_def = split(adv_m, 4)
        adv_y1, adv_y1_def = split(self.d_image1(cat([y1, y1_s2_def]))[0], 2)
        adv_y2, adv_y2_def = split(self.d_image2(cat([y2, y2_s1_def]))[0], 2)
        # Z-regressor branch: re-encode the decodes of the sampled z
        _, z_rec, _, _ = self.enc_modality(cat([s1, s2]), cat([y1_zin, y2_zin]))
        z1_rec, z2_rec = split(z_rec, 2)

        m1_t = batch["m1"]
        if supervised:
            m2_t = batch["m2"]
            seg = (losses.combined_dice_bce(m1_t, m1, nm)
                   + losses.combined_dice_bce(m2_t, m2, nm)
                   + losses.combined_dice_bce(m1_t, m1_s2_def, nm)
                   + losses.combined_dice_bce(m2_t, m2_s1_def, nm))
        else:
            seg = (losses.combined_dice_bce(m1_t, m1, nm)
                   + losses.combined_dice_bce(m1_t, m1_s2_def, nm))
        adv_m = sum(losses.lsgan_fool(a) for a in (adv_m1, adv_m2, adv_m1_def, adv_m2_def))
        rec = (losses.mae(x1, y1) + losses.mae(x2, y2)
               + losses.mae(x1, y1_s2_def) + losses.mae(x2, y2_s1_def))
        adv_x = sum(losses.lsgan_fool(a) for a in (adv_y1, adv_y2, adv_y1_def, adv_y2_def))
        kl = losses.ypred_loss(kl1) + losses.ypred_loss(kl2)
        z_rec = losses.mae(z1_in, z1_rec) + losses.mae(z2_in, z2_rec)
        total = (conf.w_sup_M * seg + conf.w_adv_M * adv_m + conf.w_rec_X * rec
                 + conf.w_adv_X * adv_x + conf.w_kl * kl + conf.w_rec_Z * z_rec)
        metrics = {
            "supervised_Mask": seg,
            "adv_M": adv_m,
            "rec_X": rec,
            "adv_X1": losses.lsgan_fool(adv_y1) + losses.lsgan_fool(adv_y1_def),
            "adv_X2": losses.lsgan_fool(adv_y2) + losses.lsgan_fool(adv_y2_def),
            "KL": kl,
            "rec_Z": z_rec,
            "loss": total,
        }
        return total, metrics

    # -------------------------------------------------- discriminator losses

    @torch.no_grad()
    def make_fake_pools(self, x1, x2, mask_idx, eps, image_idx):
        """Fake pools for all discriminators from one generator forward
        (models/dafnet.py:506-594), with the generator as it stands; call
        it in eval mode (running BatchNorm statistics).

        Args:
          x1, x2: (B, H, W, 1) NHWC pool images.
          mask_idx: two (B,) slot indices in {0, 1}: the m1 pool draws from
            [s1, s2_def], the m2 pool from [s2, s1_def].
          eps: (2B, num_z) modality-encoder noise, interleaved [x1, x2].
          image_idx: two (B,) slot indices in {0, 1, 2}: the y1 pool draws
            from [s1, s2_def, s1_def], the y2 pool from [s2, s1_def, s2_def].

        Returns:
          (fake_m1, fake_m2, fake_y1, fake_y2), detached: NHWC masks
          (B, H, W, num_masks) and images (B, H, W, 1).
        """
        nm = self.conf.num_masks
        x1, x2 = _nchw(x1), _nchw(x2)
        s1, s2 = self.enc_anatomy(x1, x2)
        s_def, _ = self.fuser(cat([s1, s2]), cat([s2, s1]))
        s1_def, s2_def = split(s_def, 2)
        # the slot select runs on the anatomies, before the (per-sample,
        # eval-mode) segmentor and decoder
        sel1 = subsample_pool(mask_idx[0], [s1, s2_def])
        sel2 = subsample_pool(mask_idx[1], [s2, s1_def])
        fake1, fake2 = split(_nhwc(self.segmentor(cat([sel1, sel2]))), 2)
        z, _, _, _ = self.enc_modality(cat([s1, s2]), cat([x1, x2]), eps)
        z1, z2 = split(z, 2)
        sel_s1 = subsample_pool(image_idx[0], [s1, s2_def, s1_def])
        sel_s2 = subsample_pool(image_idx[1], [s2, s1_def, s2_def])
        fake_y1, fake_y2 = split(_nhwc(self.decoder(cat([sel_s1, sel_s2]), cat([z1, z2]))), 2)
        return fake1[..., :nm], fake2[..., :nm], fake_y1, fake_y2

    def d_mask_pair_loss(self, real_m, fake_m):
        """One real/fake LSGAN pair plus the spectral penalty for the mask
        discriminator (models/dafnet.py:596-615): the loss of one of the
        reference's two D_Mask fits per batch. Updates d_mask's `u`.
        real_m, fake_m: NHWC (B, H, W, num_masks)."""
        d_all, penalty = self.d_mask(_nchw(cat([real_m, fake_m.detach()])),
                                     collect_spectral=True)
        d_real, d_fake = split(d_all, 2)
        loss = losses.lsgan_disc(d_real, d_fake) + penalty
        return loss, {"dis_M": loss}

    def d_image_pair_loss(self, x1, x2, y1, y2):
        """LSGAN real/fake losses plus spectral penalties of both image
        discriminators, with the fake pools y1, y2 precomputed
        (models/dafnet.py:631-653). Updates both discriminators' `u`.
        All NHWC (B, H, W, 1)."""
        d1, p1 = self.d_image1(_nchw(cat([x1, y1.detach()])), collect_spectral=True)
        d2, p2 = self.d_image2(_nchw(cat([x2, y2.detach()])), collect_spectral=True)
        loss1 = losses.lsgan_disc(*split(d1, 2)) + p1
        loss2 = losses.lsgan_disc(*split(d2, 2)) + p2
        return loss1 + loss2, {"dis_X1": loss1, "dis_X2": loss2}

    @torch.inference_mode()
    def predict_mask(self, modality_index, fusion_type, images, device="cuda"):
        """Segment modality `modality_index` from both modalities' images
        (models/mmsdnet.py:210-232).

        Args:
          modality_index: 0 or 1, the modality to segment.
          fusion_type: 'simple' | 'def' | 'max' | 'maxnostn'.
          images: [x_mod0, x_mod1], each (B, H, W, 1) numpy array or tensor.
          device: where the model's weights are and the work runs.

        Returns:
          (B, H, W, num_masks + 1) f32 mask probabilities on `device`.
        """
        if fusion_type not in FUSION_TYPES:
            raise ValueError("fusion_type must be one of %s, got %r"
                             % (FUSION_TYPES, fusion_type))
        dev = resolve_device(device)
        w_dev = next(self.parameters()).device
        if w_dev != dev:
            raise ValueError("the model's weights are on %s, not on %s" % (w_dev, dev))
        x = [torch.as_tensor(im, dtype=torch.float32, device=dev).permute(0, 3, 1, 2)
             for im in images]
        idx2 = modality_index
        idx1 = 1 - idx2
        # encoder 1 is tied to modality 0's private path
        if idx1 == 0:
            s1, s2 = self.enc_anatomy(x[idx1], x[idx2])
        else:
            s2, s1 = self.enc_anatomy(x[idx2], x[idx1])

        if fusion_type == "simple":
            s = s2
        elif fusion_type == "maxnostn":
            s = torch.maximum(s1, s2)
        else:
            s_def, s_fused = self.fuser(s1, s2, fast=True)
            s = s_def if fusion_type == "def" else s_fused
        return self.segmentor(s).permute(0, 2, 3, 1)
