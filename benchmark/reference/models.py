"""DAFNet and MMSDNet in plain PyTorch: components, the generator losses
(expert and automated pairing for DAFNet), the fake pools, the
discriminator losses and `predict_mask`. A frozen copy of the port's
models/dafnet.py, models/mmsdnet.py and models/base.py, with the same
component names and the same interleaved batch stacking (one call over
several inputs, per-input BatchNorm statistics), in float32.

`conf` is a namespace of the configuration file's `model` fields
(benchmark/configs/*.json). A configuration finds its model class through
the module named after it (dafnet.py, mmsdnet.py; harness/common.py's
`reference_model`).
"""

import torch
from torch import nn

from benchmark.reference import losses
from benchmark.reference.layers import (
    AnatomyEncoder,
    AnatomyFuser,
    Balancer,
    Decoder,
    Discriminator,
    DualAnatomyEncoder,
    ModalityEncoder,
    Segmentor,
)
from benchmark.reference.layers import deinterleave as split
from benchmark.reference.layers import interleave as cat


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def add_residual(masks):
    """A background channel, 1 - the union of the masks, appended."""
    hit = (masks == 1.0).to(masks.dtype)
    return torch.cat([masks, 1.0 - torch.amax(hit, dim=-1, keepdim=True)], dim=-1)


def subsample_pool(slot_idx, variants):
    """Slot b of the result is variants[slot_idx[b]][b]."""
    shape = (slot_idx.shape[0],) + (1,) * (variants[0].dim() - 1)
    idx = slot_idx.reshape(shape)
    out = variants[0]
    for j in range(1, len(variants)):
        out = torch.where(idx == j, variants[j], out)
    return out


class _Model(nn.Module):
    def component_parameters(self, names):
        return [p for n in names for p in getattr(self, n).parameters()]

    @torch.no_grad()
    def predict_mask(self, modality_index, images):
        """Mask probabilities (B, H, W, num_masks + 1) of modality
        `modality_index` from both modalities' (B, H, W, 1) images, with
        'max' fusion: the other modality's anatomy warped into this one's
        space and the pixelwise max taken."""
        x = [_nchw(im.float()) for im in images]
        anatomies = self.encode_anatomies(x[0], x[1])
        s1, s2 = anatomies[1 - modality_index], anatomies[modality_index]
        _, fused = self.fuser(s1, s2)
        return _nhwc(self.segmentor(fused))


class DAFNet(_Model):
    GEN_COMPONENTS = ("enc_anatomy", "fuser", "enc_modality", "segmentor", "decoder", "balancer")
    DISC_COMPONENTS = ("d_mask", "d_image1", "d_image2")

    def __init__(self, conf):
        super().__init__()
        self.conf = conf
        ae = conf.anatomy_encoder
        sc = ae.out_channels
        hw = conf.input_hw
        self.enc_anatomy = DualAnatomyEncoder(ae.filters, ae.downsample, sc)
        self.fuser = AnatomyFuser(sc, hw)
        self.enc_modality = ModalityEncoder(sc + 1, hw, conf.num_z)
        self.segmentor = Segmentor(sc, conf.num_masks)
        self.decoder = Decoder(conf.decoder_type, sc, conf.num_z)
        self.balancer = Balancer(conf.n_pairs)
        dm, di = conf.d_mask_params, conf.d_image_params
        self.d_mask = Discriminator(conf.num_masks, hw, dm.filters, dm.downsample_blocks)
        self.d_image1 = Discriminator(1, hw, di.filters, di.downsample_blocks)
        self.d_image2 = Discriminator(1, hw, di.filters, di.downsample_blocks)

    def encode_anatomies(self, x1, x2):
        return self.enc_anatomy(x1, x2)

    def _losses(self, x1, x2, z1_in, z2_in, y1, y2, adv, z_rec, kl, seg, rec_def=None):
        conf = self.conf
        adv_m1, adv_m2, adv_m1_def, adv_m2_def, adv_y1, adv_y1_def, adv_y2, adv_y2_def = adv
        y1, y1_def, y2, y2_def = y1[0], y1[1], y2[0], y2[1]
        adv_m = sum(losses.lsgan_fool(a) for a in (adv_m1, adv_m2, adv_m1_def, adv_m2_def))
        if rec_def is None:
            rec = (losses.mae(x1, y1) + losses.mae(x2, y2)
                   + losses.mae(x1, y1_def) + losses.mae(x2, y2_def))
        else:
            rec = losses.mae(x1, y1) + losses.mae(x2, y2) + rec_def
        adv_x = sum(losses.lsgan_fool(a) for a in (adv_y1, adv_y2, adv_y1_def, adv_y2_def))
        z_rec_loss = losses.mae(z1_in, z_rec[0]) + losses.mae(z2_in, z_rec[1])
        kl = torch.mean(kl[0]) + torch.mean(kl[1])
        total = (conf.w_sup_M * seg + conf.w_adv_M * adv_m + conf.w_rec_X * rec
                 + conf.w_adv_X * adv_x + conf.w_kl * kl + conf.w_rec_Z * z_rec_loss)
        return total, {
            "supervised_Mask": seg, "adv_M": adv_m, "rec_X": rec,
            "adv_X1": losses.lsgan_fool(adv_y1) + losses.lsgan_fool(adv_y1_def),
            "adv_X2": losses.lsgan_fool(adv_y2) + losses.lsgan_fool(adv_y2_def),
            "KL": kl, "rec_Z": z_rec_loss, "loss": total,
        }

    def gen_loss_expert(self, batch, gen_eps, supervised):
        nm = self.conf.num_masks
        x1, x2 = _nchw(batch["x1"]), _nchw(batch["x2"])
        s1, s2 = self.enc_anatomy(x1, x2)
        s_def, _ = self.fuser(cat([s1, s2]), cat([s2, s1]))
        s1_def, s2_def = split(s_def, 2)
        z, _, _, kl = self.enc_modality(cat([s1, s2]), cat([x1, x2]), gen_eps)
        z1, z2 = split(z, 2)
        m1, m2, m1_s2_def, m2_s1_def = split(
            _nhwc(self.segmentor(cat([s1, s2, s2_def, s1_def]), groups=4)), 4)
        y1, y2, y1_s2_def, y2_s1_def, y1_zin, y2_zin = split(
            self.decoder(cat([s1, s2, s2_def, s1_def, s1, s2]),
                         cat([z1, z2, z1, z2, batch["z1"], batch["z2"]])), 6)
        adv_m, _ = self.d_mask(_nchw(cat([m1, m2, m1_s2_def, m2_s1_def])[..., :nm]))
        adv_y1, adv_y1_def = split(self.d_image1(cat([y1, y1_s2_def]))[0], 2)
        adv_y2, adv_y2_def = split(self.d_image2(cat([y2, y2_s1_def]))[0], 2)
        _, z_rec, _, _ = self.enc_modality(cat([s1, s2]), cat([y1_zin, y2_zin]))
        m1_t = batch["m1"]
        seg = (losses.combined_dice_bce(m1_t, m1, nm)
               + losses.combined_dice_bce(m1_t, m1_s2_def, nm))
        if supervised:
            m2_t = batch["m2"]
            seg = (losses.combined_dice_bce(m1_t, m1, nm) + losses.combined_dice_bce(m2_t, m2, nm)
                   + losses.combined_dice_bce(m1_t, m1_s2_def, nm)
                   + losses.combined_dice_bce(m2_t, m2_s1_def, nm))
        return self._losses(x1, x2, batch["z1"], batch["z2"], (y1, y1_s2_def), (y2, y2_s1_def),
                            split(adv_m, 4) + [adv_y1, adv_y1_def, adv_y2, adv_y2_def],
                            split(z_rec, 2), split(kl, 2), seg)

    def gen_loss_automated(self, batch, gen_eps, supervised):
        nm = self.conf.num_masks
        K = self.conf.n_pairs
        x1_list = [_nchw(batch["x1_pairs"][..., i:i + 1]) for i in range(K)]
        x2_list = [_nchw(batch["x2_pairs"][..., i:i + 1]) for i in range(K)]
        x1, x2 = x1_list[0], x2_list[0]
        sa, sb = self.enc_anatomy(cat(x1_list), cat(x2_list), pair_groups=K)
        s1_list, s2_list = split(sa, K), split(sb, K)
        s1, s2 = s1_list[0], s2_list[0]
        z, _, _, kl = self.enc_modality(cat([s1, s2]), cat([x1, x2]), gen_eps)
        z1, z2 = split(z, 2)
        s_def, _ = self.fuser(cat(s1_list + s2_list), cat([s2] * K + [s1] * K))
        defs = split(s_def, 2 * K)
        s1_def_list, s2_def_list = defs[:K], defs[K:]
        w1, w2 = split(self.balancer(cat([s2, s1]), [cat([s1_def_list[j], s2_def_list[j]])
                                                     for j in range(K)]), 2)
        parts = split(_nhwc(self.segmentor(cat([s1, s2] + s2_def_list + s1_def_list),
                                           groups=2 + 2 * K)), 2 + 2 * K)
        m1, m2 = parts[0], parts[1]
        m1_def_list, m2_def_list = parts[2:2 + K], parts[2 + K:]
        yparts = split(self.decoder(cat([s1, s2] + s1_def_list + s2_def_list + [s1, s2]),
                                    cat([z1, z2] + [z2] * K + [z1] * K
                                        + [batch["z1"], batch["z2"]])), 4 + 2 * K)
        y1, y2 = yparts[0], yparts[1]
        y2_def_list, y1_def_list = yparts[2:2 + K], yparts[2 + K:2 + 2 * K]
        y1_zin, y2_zin = yparts[-2], yparts[-1]
        rec_def = sum(torch.mean(w1[:, j:j + 1] * losses.mae_perbatch(_nhwc(x2),
                                                                      _nhwc(y2_def_list[j])))
                      for j in range(K)) + sum(
            torch.mean(w2[:, j:j + 1] * losses.mae_perbatch(_nhwc(x1), _nhwc(y1_def_list[j])))
            for j in range(K))
        m1_t = batch["m1"]
        seg_def = sum(torch.mean(w2[:, j] * losses.combined_dice_bce_perbatch(
            m1_t, m1_def_list[j], nm)) for j in range(K))
        seg = losses.combined_dice_bce(m1_t, m1, nm)
        if supervised:
            m2_t = batch["m2"]
            seg_def = seg_def + sum(torch.mean(w1[:, j] * losses.combined_dice_bce_perbatch(
                m2_t, m2_def_list[j], nm)) for j in range(K))
            seg = seg + losses.combined_dice_bce(m2_t, m2, nm)
        adv_m, _ = self.d_mask(_nchw(cat([m1, m2, m1_def_list[0], m2_def_list[0]])[..., :nm]))
        adv_y1, adv_y1_def = split(self.d_image1(cat([y1, y1_def_list[0]]))[0], 2)
        adv_y2, adv_y2_def = split(self.d_image2(cat([y2, y2_def_list[0]]))[0], 2)
        _, z_rec, _, _ = self.enc_modality(cat([s1, s2]), cat([y1_zin, y2_zin]))
        return self._losses(x1, x2, batch["z1"], batch["z2"], (y1, None), (y2, None),
                            split(adv_m, 4) + [adv_y1, adv_y1_def, adv_y2, adv_y2_def],
                            split(z_rec, 2), split(kl, 2), seg + seg_def, rec_def)

    @torch.no_grad()
    def make_fake_pools(self, x1, x2, mask_idx, eps, image_idx):
        nm = self.conf.num_masks
        x1, x2 = _nchw(x1), _nchw(x2)
        s1, s2 = self.enc_anatomy(x1, x2)
        s1_def, s2_def = split(self.fuser(cat([s1, s2]), cat([s2, s1]))[0], 2)
        sel1 = subsample_pool(mask_idx[0], [s1, s2_def])
        sel2 = subsample_pool(mask_idx[1], [s2, s1_def])
        fake1, fake2 = split(_nhwc(self.segmentor(cat([sel1, sel2]))), 2)
        z1, z2 = split(self.enc_modality(cat([s1, s2]), cat([x1, x2]), eps)[0], 2)
        sel_s1 = subsample_pool(image_idx[0], [s1, s2_def, s1_def])
        sel_s2 = subsample_pool(image_idx[1], [s2, s1_def, s2_def])
        fake_y1, fake_y2 = split(_nhwc(self.decoder(cat([sel_s1, sel_s2]), cat([z1, z2]))), 2)
        return fake1[..., :nm], fake2[..., :nm], fake_y1, fake_y2

    def d_mask_pair_loss(self, real_m, fake_m):
        d_all, penalty = self.d_mask(_nchw(cat([real_m, fake_m.detach()])), collect_spectral=True)
        return losses.lsgan_disc(*split(d_all, 2)) + penalty

    def d_image_pair_loss(self, x1, x2, y1, y2):
        d1, p1 = self.d_image1(_nchw(cat([x1, y1.detach()])), collect_spectral=True)
        d2, p2 = self.d_image2(_nchw(cat([x2, y2.detach()])), collect_spectral=True)
        loss1 = losses.lsgan_disc(*split(d1, 2)) + p1
        loss2 = losses.lsgan_disc(*split(d2, 2)) + p2
        return loss1 + loss2, {"dis_X1": loss1, "dis_X2": loss2}


class MMSDNet(_Model):
    GEN_COMPONENTS = ("enc_anatomy1", "enc_anatomy2", "fuser", "enc_modality", "segmentor",
                      "decoder")
    DISC_COMPONENTS = ("d_mask",)
    ZREG_COMPONENTS = ("decoder", "enc_modality")

    def __init__(self, conf):
        super().__init__()
        self.conf = conf
        ae = conf.anatomy_encoder
        sc = ae.out_channels
        hw = conf.input_hw
        self.enc_anatomy1 = AnatomyEncoder(ae.filters, ae.downsample, sc)
        self.enc_anatomy2 = AnatomyEncoder(ae.filters, ae.downsample, sc)
        self.fuser = AnatomyFuser(sc, hw)
        self.enc_modality = ModalityEncoder(sc + 1, hw, conf.num_z)
        self.segmentor = Segmentor(sc, conf.num_masks)
        self.decoder = Decoder(conf.decoder_type, sc, conf.num_z)
        dm = conf.d_mask_params
        self.d_mask = Discriminator(conf.num_masks, hw, dm.filters, dm.downsample_blocks)

    def encode_anatomies(self, x1, x2):
        return self.enc_anatomy1(x1), self.enc_anatomy2(x2)

    def gen_loss(self, batch, gen_eps, supervised):
        conf = self.conf
        nm = conf.num_masks
        x1, x2 = _nchw(batch["x1"]), _nchw(batch["x2"])
        s1, s2 = self.encode_anatomies(x1, x2)
        s_def, s_fused = self.fuser(cat([s1, s2]), cat([s2, s1]))
        s1_def, s2_def = split(s_def, 2)
        s1_fused, s2_fused = split(s_fused, 2)
        s_all = cat([s1, s2, s1_def, s1_fused, s2_def, s2_fused])
        z_all, _, _, kl_all = self.enc_modality(s_all, cat([x1, x2, x2, x2, x1, x1]), gen_eps)
        ms = split(_nhwc(self.segmentor(s_all, groups=6)), 6)
        ys = split(self.decoder(s_all, z_all), 6)
        m1_t = batch["m1"]
        if supervised:
            m2_t = batch["m2"]
            seg_pairs = [(m1_t, ms[0]), (m2_t, ms[1]), (m2_t, ms[2]), (m2_t, ms[3]),
                         (m1_t, ms[4]), (m1_t, ms[5])]
        else:
            seg_pairs = [(m1_t, ms[0]), (m1_t, ms[4]), (m1_t, ms[5])]
        seg = sum(losses.restricted_dice_loss(t, p, nm) for t, p in seg_pairs)
        adv_all, _ = self.d_mask(_nchw(cat([m[..., :nm] for m in ms])))
        adv_m = sum(losses.lsgan_fool(a) for a in split(adv_all, 6))
        rec = sum(losses.mae(t, p) for t, p in zip((x1, x2, x2, x2, x1, x1), ys))
        kl = sum(torch.mean(k) for k in split(kl_all, 6))
        total = conf.w_sup_M * seg + conf.w_adv_M * adv_m + conf.w_rec_X * rec + conf.w_kl * kl
        return total, {"supervised_Mask": seg, "adv_M": adv_m, "rec_X": rec, "KL": kl,
                       "loss": total}

    @torch.no_grad()
    def make_z_regressor_anatomies(self, x1, x2):
        s1, s2 = self.encode_anatomies(_nchw(x1), _nchw(x2))
        s_def, s_fused = self.fuser(cat([s1, s2]), cat([s2, s1]))
        s1_def, s2_def = split(s_def, 2)
        s1_fused, s2_fused = split(s_fused, 2)
        return [s1, s2, s1_def, s1_fused, s2_def, s2_fused]

    def z_regressor_loss(self, s_list, z_list):
        s = cat(s_list)
        _, mu, _, _ = self.enc_modality(s, self.decoder(s, cat(z_list)))
        total = self.conf.w_rec_Z * sum(losses.mae(z, m) for z, m in zip(z_list,
                                                                          split(mu, len(s_list))))
        return total, {"rec_Z": total}

    @torch.no_grad()
    def make_fake_masks(self, x1, x2, pool_idx):
        s1, s2 = self.encode_anatomies(_nchw(x1), _nchw(x2))
        s1_def, s1_fused = self.fuser(s1, s2)
        sel = subsample_pool(pool_idx, [s1, s2, s1_def, s1_fused])
        return _nhwc(self.segmentor(sel))[..., :self.conf.num_masks]

    def d_mask_loss(self, real_m, fake_m):
        d_all, penalty = self.d_mask(_nchw(cat([real_m, fake_m.detach()])), collect_spectral=True)
        loss = losses.lsgan_disc(*split(d_all, 2)) + penalty
        return loss, {"dis_M": loss}

