"""CPU parity of the training slice's components with the JAX package's, at
the tiny config, on the JAX weights carried over by utils/convert.py
(tests/torch_parity.py): the modality encoder (its noise passed in), the
FiLM decoder, the spectral-norm discriminator, the balancer, and the
conversion of all nine components in both directions."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_segmentation_tpu import config as jconfig
from multimodal_segmentation_tpu import nn as jnn
from multimodal_segmentation_tpu.models import build_model as build_jax_model
from multimodal_segmentation_torch import config as tconfig
from multimodal_segmentation_torch import nn as tnn
from multimodal_segmentation_torch.models import build_model as build_torch_model
from multimodal_segmentation_torch.utils.convert import (
    COMPONENTS,
    component_state_dict,
    component_trees,
)
from torch_parity import (
    bf16_gap_check as _bf16_gap_check,
    dtypes_by_layer as _dtypes_by_layer,
    jax_dafnet,
    jax_sample_eps,
    nchw,
    nhwc,
    torch_dafnet,
)

torch.set_num_threads(1)

CONF = jconfig.tiny_test_config()
TCONF = tconfig.tiny_test_config()
_, PARAMS, STATE = jax_dafnet(CONF)
NZ = CONF.num_z


def _anatomy(B, seed, C=8, hw=32):
    r = np.random.RandomState(seed)
    lab = r.randint(0, C + 1, size=(B, hw, hw))
    return (lab[..., None] == np.arange(C)).astype(np.float32)


def _images(shape, seed):
    return (np.random.RandomState(seed).rand(*shape).astype(np.float32) * 2 - 1)


def _load_params(module, params):
    module.load_state_dict(component_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    return module


def _load(module, name):
    module.load_state_dict(component_state_dict(
        PARAMS[name], STATE["batch_stats"].get(name), STATE.get("spectral", {}).get(name)))
    return module


@pytest.mark.parametrize("sample", [True, False])
def test_modality_encoder_matches_jax(sample):
    """z, z_mean, z_log_var and KL at 1e-5; the JAX noise is read out with
    jax_sample_eps and passed to the port."""
    s, x = _anatomy(4, 1), _images((4, 32, 32, 1), 2)
    key = jax.random.PRNGKey(3)
    ref = jnn.ModalityEncoder(NZ).apply({"params": PARAMS["enc_modality"]}, s, x,
                                        rngs={"sample": key} if sample else None,
                                        sample=sample)
    eps = torch.from_numpy(jax_sample_eps(PARAMS, key, 4, (32, 32))) if sample else None
    enc = _load(tnn.ModalityEncoder(9, (32, 32), NZ), "enc_modality")
    got = enc(nchw(s), nchw(x), eps)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)
    if sample:
        assert not np.allclose(np.asarray(ref[0]), np.asarray(ref[1]))


def test_modality_encoder_gradients_match_jax():
    s, x = _anatomy(2, 4), _images((2, 32, 32, 1), 5)
    eps = np.random.RandomState(6).randn(2, NZ).astype(np.float32)
    p = PARAMS["enc_modality"]

    def jf(p, x):
        z, mu, lv, kl = jnn.ModalityEncoder(NZ).apply({"params": p}, s, x, sample=False)
        z = mu + jnp.exp(0.5 * lv) * eps
        return jnp.sum(z ** 2) + jnp.sum(kl)

    ref_p, ref_x = jax.grad(jf, argnums=(0, 1))(p, jnp.asarray(x))
    enc = _load(tnn.ModalityEncoder(9, (32, 32), NZ), "enc_modality")
    xt = nchw(x).clone().requires_grad_(True)
    z, _, _, kl = enc(nchw(s), xt, torch.from_numpy(eps))
    (torch.sum(z ** 2) + torch.sum(kl)).backward()
    got_p = component_trees({k: v.grad for k, v in enc.named_parameters()})["params"]
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref_p):
        g = functools.reduce(lambda d, k: d[k.key], path, got_p)
        np.testing.assert_allclose(g, np.asarray(leaf), atol=1e-5 * np.abs(leaf).max(),
                                   rtol=0, err_msg=jax.tree_util.keystr(path))
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(ref_x),
                               atol=1e-5 * np.abs(ref_x).max(), rtol=0)


def test_film_decoder_matches_jax():
    s = _anatomy(3, 7)
    z = np.random.RandomState(8).randn(3, NZ).astype(np.float32)
    ref = jnn.Decoder("film", (32, 32)).apply({"params": PARAMS["decoder"]}, s, z)
    dec = _load(tnn.Decoder("film", 8, NZ), "decoder")
    got = dec(nchw(s), torch.from_numpy(z))
    assert got.shape == (3, 1, 32, 32)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("seed", [1, 5, 9])
def test_modality_encoder_bf16_matches_jax(seed):
    """compute dtype bfloat16: every layer's output dtype is the Flax
    layer's (Dense_0 in bf16, the VAE heads in f32), z, z_mean, z_log_var
    and KL are f32 as in JAX, and each lies within 3 times JAX's own
    bf16-to-f32 gap of JAX's bf16 value. That gap is 4.7e-3 to 1.8e-2 at
    these seeds (values up to 5.4); the port's bf16 was 0.57 to 1.92 of it
    (roundoff: the conv sums round at other places)."""
    s, x = _anatomy(4, seed), _images((4, 32, 32, 1), seed + 1)
    key = jax.random.PRNGKey(3)
    eps = torch.from_numpy(jax_sample_eps(PARAMS, key, 4, (32, 32)))
    v = {"params": PARAMS["enc_modality"]}
    ref, got, mods = {}, {}, {}
    for dt in ("float32", "bfloat16"):
        ref[dt] = jnn.ModalityEncoder(NZ, dtype=getattr(jnp, dt)).apply(v, s, x, rngs={"sample": key})
        mods[dt] = _load(tnn.ModalityEncoder(9, (32, 32), NZ, getattr(torch, dt)), "enc_modality")
        got[dt] = mods[dt](nchw(s), nchw(x), eps)
    _bf16_gap_check(got["bfloat16"], got["float32"], ref["bfloat16"], ref["float32"])
    got_dt, want_dt = _dtypes_by_layer(
        jnn.ModalityEncoder(NZ, dtype=jnp.bfloat16), v, mods["bfloat16"],
        (s, x, False, False), (nchw(s), nchw(x)))
    assert got_dt == want_dt and want_dt["Dense_0"] == "bfloat16" and want_dt["z_mean"] == "float32"


@pytest.mark.parametrize("seed", [7, 11, 13])
def test_film_decoder_bf16_matches_jax(seed):
    """compute dtype bfloat16: every layer's output dtype is the Flax
    layer's (the FiLM convs and Denses in bf16, the 1x1 tanh conv in f32)
    and the f32 image lies within 3 times JAX's own bf16-to-f32 gap of
    JAX's bf16 image. That gap is 0.021 to 0.072 at these seeds (values up
    to 1.0). The port's bf16 image was 0.056, 0.031 and 0.021 from JAX's,
    0.78 to 1.2 times JAX's gap; at seed 7 it is 0.108 from the port's
    f32 image against JAX's 0.072, and RMS 9.2e-3 against 7.1e-3. That is
    bf16 roundoff through four residual layers, not an f32 island: the
    Denses agree exactly, the first FiLM conv by one bf16 ulp (another
    summation order), and the gap grows by about an ulp of the activations
    a layer; computing the FiLM layers' elementwise tail in f32 (as XLA
    may fuse it) does not bring the port closer to JAX's bf16."""
    r = np.random.RandomState(seed)
    s = (r.randint(0, 9, size=(3, 32, 32))[..., None] == np.arange(8)).astype(np.float32)
    z = np.random.RandomState(seed + 1).randn(3, NZ).astype(np.float32)
    v = {"params": PARAMS["decoder"]}
    ref, got, mods = {}, {}, {}
    for dt in ("float32", "bfloat16"):
        ref[dt] = jnn.Decoder("film", (32, 32), dtype=getattr(jnp, dt)).apply(v, s, z)
        mods[dt] = _load(tnn.Decoder("film", 8, NZ, getattr(torch, dt)), "decoder")
        got[dt] = mods[dt](nchw(s), torch.from_numpy(z)).permute(0, 2, 3, 1)
    _bf16_gap_check([got["bfloat16"]], [got["float32"]], [ref["bfloat16"]], [ref["float32"]])
    got_dt, want_dt = _dtypes_by_layer(
        jnn.Decoder("film", (32, 32), dtype=jnp.bfloat16), v, mods["bfloat16"], (s, z),
        (nchw(s), torch.from_numpy(z)))
    assert got_dt == want_dt
    assert want_dt["FiLMDecoder_0.FiLMLayer_0.Dense_0"] == "bfloat16"
    assert want_dt["FiLMDecoder_0.Conv_1"] == "float32"


def test_spade_decoder_not_ported():
    """The SPADE decoder is ported: on a JAX-initialised SPADE decoder's
    weights its image lies within 1e-5 of JAX's (tests/test_torch_spade.py
    holds it block by block, in bf16 and through the training step)."""
    s = _anatomy(3, 7)
    z = np.random.RandomState(8).randn(3, NZ).astype(np.float32)
    jdec = jnn.Decoder("spade", (32, 32))
    params = jax.jit(jdec.init)(jax.random.PRNGKey(4), s, z)["params"]
    ref = jax.jit(jdec.apply)({"params": params}, s, z)
    dec = _load_params(tnn.Decoder("spade", 8, NZ, torch.float32, (32, 32)), params)
    got = dec(nchw(s), torch.from_numpy(z))
    assert got.shape == (3, 1, 32, 32)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("name,in_ch", [("d_mask", 4), ("d_image1", 1)])
def test_discriminator_output_penalty_and_u_match_jax(name, in_ch):
    """Scores at 1e-5; the summed spectral penalty at 1e-5 relative and
    the new u vectors at 1e-5, with collect_spectral; without it, u stays."""
    x = _images((4, 32, 32, in_ch), 9)
    variables = {"params": PARAMS[name], "spectral": STATE["spectral"][name]}
    jd = jnn.Discriminator(4, 2)
    ref, upd = jd.apply(variables, x, mutable=["spectral", "spectral_loss"])
    ref_pen = sum(jax.tree_util.tree_leaves(upd["spectral_loss"]))

    d = _load(tnn.Discriminator(in_ch, (32, 32), 4, 2), name)
    u0 = [c.u.clone() for c in d.spectral_convs()]
    out, pen = d(nchw(x))
    assert pen is None
    for c, u in zip(d.spectral_convs(), u0):
        assert torch.equal(c.u, u)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5)

    out, pen = d(nchw(x), collect_spectral=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(float(pen.detach()), float(ref_pen), rtol=1e-5)
    for i, c in enumerate(d.spectral_convs()):
        np.testing.assert_allclose(c.u.numpy(), upd["spectral"]["SpectralConv_%d" % i]["u"],
                                   atol=1e-5)


def test_balancer_matches_jax():
    s = _anatomy(2, 10)
    cands = [_anatomy(2, 11 + i) for i in range(CONF.n_pairs)]
    ref = jnn.Balancer(CONF.n_pairs).apply({"params": PARAMS["balancer"]}, s, cands)
    bal = _load(tnn.Balancer(CONF.n_pairs), "balancer")
    got = bal(nchw(s), [nchw(c) for c in cands])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("name", COMPONENTS)
def test_convert_round_trip(name):
    """JAX trees -> the port's module (strict load) -> JAX trees, exactly,
    for params, batch_stats and the spectral vectors."""
    model = torch_dafnet(TCONF, PARAMS, STATE)
    trees = component_trees(getattr(model, name).state_dict())
    ref = {"params": PARAMS[name]}
    for col in ("batch_stats", "spectral"):
        if name in STATE.get(col, {}):
            ref[col] = STATE[col][name]
    assert sorted(trees) == sorted(ref)
    for col, tree in ref.items():
        got = jax.tree_util.tree_leaves_with_path(trees[col])
        want = jax.tree_util.tree_leaves_with_path(tree)
        assert [jax.tree_util.keystr(p) for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
        for (p, a), (_, b) in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=jax.tree_util.keystr(p))


@functools.lru_cache(maxsize=None)
def _counts(preset):
    if preset == "tiny":
        jconf, tconf = jconfig.tiny_test_config(), tconfig.tiny_test_config()
    else:
        jconf, tconf = jconfig.get_config(preset), tconfig.get_config(preset)
    shapes = jax.eval_shape(lambda: build_jax_model(jconf).init(jax.random.PRNGKey(0)))
    tmodel = build_torch_model(tconf, device="cpu")
    out = {}
    for c in COMPONENTS:
        tree = {"params": shapes[0][c]}
        tree.update({col: shapes[1][col][c] for col in ("spectral",) if c in shapes[1].get(col, {})})
        out[c] = (sum(int(np.prod(l.shape)) for l in jax.tree_util.tree_leaves(tree)),
                  sum(p.numel() for p in getattr(tmodel, c).parameters())
                  + sum(b.numel() for n, b in getattr(tmodel, c).named_buffers() if n.endswith(".u")))
    return out


@pytest.mark.parametrize("preset", ["tiny", "dafnet_chaos", "dafnet_spade_chaos"])
@pytest.mark.parametrize("component", ["enc_modality", "decoder", "balancer",
                                       "d_mask", "d_image1", "d_image2"])
def test_training_component_sizes_match_jax(preset, component):
    """Parameters (and spectral vectors) of the training components."""
    n_jax, n_torch = _counts(preset)[component]
    assert n_torch == n_jax
