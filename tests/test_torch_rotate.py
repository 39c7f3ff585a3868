"""CPU parity of the fused group rotation's plain version
(ops/augment.py::_rotate_group_plain, the plain version of the rotate_group
kernel) with the port's CPU path of random_rotate_batch and with the JAX
package's random_rotate_batch (multimodal_segmentation_tpu/ops/augment.py:
132-157), bit for bit; the wrappers' refusal of CPU tensors; the light
launch path's lock-free read of a bound kernel; the build's files of its
own process."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_segmentation_tpu.ops import augment as jaugment
from multimodal_segmentation_torch.ops import augment, cuda_kernels, tps

torch.set_num_threads(1)

# the training step's groups (train/steps.py): supervised x1, x2, m1, m2;
# unsupervised x1, x2, m1; dm1, dm2; dx1, dx2
GROUPS = {"supervised": [1, 1, 4, 4], "unsupervised": [1, 1, 4], "dm": [4, 4], "dx": [1, 1]}
ANGLES_DEG = np.array([0.0, 20.0, -20.0, 7.3, -13.9, 19.99], np.float32)


def _tie_angles(n):
    """n f32 angles whose sin or cos is exactly +-0.5 in torch and in JAX,
    with torch's and JAX's sin and cos equal: on an odd-sized image (cy, cx
    integers) they put the centre row's and column's locations on exact .5
    ties, which round half to even."""
    found = []
    for deg in (30.0, -30.0, 60.0, -60.0):
        t = np.float32(np.radians(deg))
        cand = (np.array([t]).view(np.int32) + np.arange(-256, 257, dtype=np.int32)).view(np.float32)
        ts, tc = torch.sin(torch.from_numpy(cand)).numpy(), torch.cos(torch.from_numpy(cand)).numpy()
        js, jc = np.asarray(jnp.sin(jnp.asarray(cand))), np.asarray(jnp.cos(jnp.asarray(cand)))
        ok = (((np.abs(ts) == 0.5) | (np.abs(tc) == 0.5)) & (ts == js) & (tc == jc))
        found += list(cand[ok][:1])
    assert len(found) >= 2
    return np.array((found * n)[:n], np.float32)


def _arrays(r, B, H, W, widths, masks):
    return [((r.rand(B, H, W, c) > 0.7) if masks else (r.rand(B, H, W, c) * 2 - 1))
            .astype(np.float32) for c in widths]


@pytest.mark.parametrize("angles", ["range", "ties"])
@pytest.mark.parametrize("group", list(GROUPS))
def test_group_rotation_plain_matches_cpu_path_and_jax(group, angles, monkeypatch):
    """Images and {0,1} masks, f32: the plain fused rotation, the port's
    random_rotate_batch on the CPU (concatenate, rotation_locations, plain
    gather, split) and the JAX package's random_rotate_batch with the same
    angles agree bit for bit: at 0, +-20 degrees and between (32x32), and at
    angles whose locations hit exact .5 ties (33x33)."""
    widths = GROUPS[group]
    if angles == "range":
        th, H, W = (ANGLES_DEG * np.float32(np.pi / 180.0)).astype(np.float32), 32, 32
    else:
        th, H, W = _tie_angles(4), 33, 33
        locs = augment.rotation_locations(torch.from_numpy(th), H, W)
        assert int(((locs - locs.floor()) == 0.5).sum()) > 0
    B = len(th)
    monkeypatch.setattr(jaugment, "random_rotation_angles",
                        lambda rng, batch, rotation_range_deg=20.0: jnp.asarray(th))
    r = np.random.RandomState(len(widths) + H)
    for masks in (False, True):
        arrays = _arrays(r, B, H, W, widths, masks)
        ts = [torch.from_numpy(a) for a in arrays]
        tth = torch.from_numpy(th)
        got = augment._rotate_group_plain(ts, torch.cos(tth), torch.sin(tth))
        path = augment.random_rotate_batch(ts, tth)
        ref = jaugment.random_rotate_batch(jax.random.PRNGKey(0), [jnp.asarray(a) for a in arrays])
        assert [g.shape[-1] for g in got] == widths
        for g, p, j in zip(got, path, ref):
            np.testing.assert_array_equal(g.numpy(), p.numpy())
            np.testing.assert_array_equal(g.numpy(), np.asarray(j))
        if angles == "range":   # sample 0 at 0 degrees: the identity
            for g, a in zip(got, arrays):
                np.testing.assert_array_equal(g[0].numpy(), a[0])


def test_random_rotate_batch_any_number_of_arrays_on_the_cpu():
    """More arrays than one kernel launch takes (cuda_kernels.MAX_GROUP):
    on the CPU each equals its own rotation."""
    r = np.random.RandomState(1)
    th = torch.from_numpy((ANGLES_DEG[:3] * np.float32(np.pi / 180.0)).astype(np.float32))
    arrays = [torch.from_numpy(r.rand(3, 20, 18, c).astype(np.float32)) for c in (1, 4, 2, 1, 3, 1)]
    assert len(arrays) > cuda_kernels.MAX_GROUP
    got = augment.random_rotate_batch(arrays, th)
    for g, a in zip(got, arrays):
        assert torch.equal(g, augment.rotate_batch(a, th))
    cos_t, sin_t = torch.cos(th), torch.sin(th)
    for g, p in zip(got, augment._rotate_group_plain(arrays, cos_t, sin_t)):
        assert torch.equal(g, p)


def _cpu_calls():
    r = np.random.RandomState(0)
    vol = torch.from_numpy(r.rand(2, 8, 8, 4).astype(np.float32))
    locs = torch.from_numpy((r.rand(2, 64, 2) * 8).astype(np.float32))
    off = torch.zeros(2, 25, 2)
    cs = torch.ones(2)
    return {
        "tps_warp_fwd": lambda: cuda_kernels.tps_warp_fwd(vol, tps.tps_coefficients(off),
                                                          tps.control_grid((5, 5))),
        "tps_warp_bwd": lambda: cuda_kernels.tps_warp_bwd(vol, locs, vol),
        "nearest_warp": lambda: cuda_kernels.nearest_warp(vol, locs),
        "rotate_group": lambda: cuda_kernels.rotate_group([vol, vol[..., :1].contiguous()],
                                                          cs, cs),
        "round_ste": lambda: cuda_kernels.round_ste(vol),
    }


@pytest.mark.parametrize("wrapper", sorted(_cpu_calls()))
def test_wrappers_refuse_cpu_tensors(wrapper):
    """A wrapper takes CUDA tensors only (the callers in ops/ run the plain
    versions on the CPU): a CPU tensor raises before anything is built."""
    with pytest.raises(ValueError, match="CUDA"):
        _cpu_calls()[wrapper]()


def test_plain_warp_bwd_takes_a_channels_first_g():
    """The plain warp backward, which the card holds the kernel against,
    gives the same for g as the fuser hands it over (a permuted view) as
    for g contiguous."""
    r = np.random.RandomState(2)
    vol = torch.from_numpy(r.rand(2, 16, 12, 8).astype(np.float32))
    g = torch.from_numpy(r.randn(2, 16, 12, 8).astype(np.float32))
    off = torch.from_numpy(((r.rand(2, 25, 2) - 0.5) * 0.1).astype(np.float32))
    locs = tps.tps_sample_locations(off, (16, 12))
    g_first = g.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert not g_first.is_contiguous()
    for a, b in zip(tps._tps_warp_bwd_plain(vol, locs, g), tps._tps_warp_bwd_plain(vol, locs, g_first)):
        assert torch.equal(a, b)


def test_bound_operators_are_read_without_the_lock(monkeypatch):
    """Once the library's operators are bound, Kernel.fn() reads them
    without taking the module's lock; before, it takes the lock to build
    and load the library."""
    k = cuda_kernels.Kernel("round_ste", "round_ste.cu", ("round_ste",))

    class Refuse:
        def __enter__(self):
            raise AssertionError("the lock was taken")

        def __exit__(self, *exc):
            return False

    bound = object()
    k.fns = {"round_ste": bound}
    monkeypatch.setattr(cuda_kernels, "_lock", Refuse())
    assert k.fn() is bound and k.fn("round_ste") is bound
    monkeypatch.setattr(cuda_kernels.ROUND_STE, "fns", None)
    with pytest.raises(AssertionError, match="lock"):
        cuda_kernels.ROUND_STE.fn()


def test_build_writes_files_of_its_own_process(tmp_path, monkeypatch):
    """build_all compiles each source and links under names that hold the
    process id, so two processes building in one checkout never share a
    half-written file; the library takes its place by one rename, its
    name holds torch's version, and nothing else is left in build/. The
    compilers are replaced by a stand-in that writes each -o file."""
    lib = str(tmp_path / os.path.basename(cuda_kernels.LIBRARY))
    monkeypatch.setattr(cuda_kernels, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_kernels, "LIBRARY", lib)
    monkeypatch.setattr(cuda_kernels, "_nvcc", lambda: "nvcc")
    written = []

    def finish(cmd, what):
        out = cmd[cmd.index("-o") + 1]
        written.append(out)
        with open(out, "w") as f:
            f.write(what)
        return {"seconds": 0.0, "ptxas": []}

    monkeypatch.setattr(cuda_kernels, "_start", lambda cmd: cmd)
    monkeypatch.setattr(cuda_kernels, "_finish", finish)
    info = cuda_kernels.build_all()
    assert sorted(info) == sorted([k.name for k in cuda_kernels.KERNELS] + ["ops.cpp", "link"])
    assert len(written) == len(cuda_kernels.KERNELS) + 2
    assert all(".%d." % os.getpid() in os.path.basename(p) for p in written)
    assert torch.__version__ in os.path.basename(lib)
    assert os.listdir(tmp_path) == [os.path.basename(lib)]
