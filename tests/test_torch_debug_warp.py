"""CPU parity of the warp's flow-stage dump (kernel B5's plain version,
ops/tps.py::_tps_flow_stage_plain) with the JAX package's TPU bisect,
tools/debug_warp_kernel.py::flow_dbg, run in interpret mode; the plain
version against float64; the port's tool; and the CPU dispatch and
build bookkeeping around the kernel."""

import contextlib
import io
import os
import runpy

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from multimodal_segmentation_torch.ops import cuda_kernels, tps
from multimodal_segmentation_torch.tools import debug_warp_kernel

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_tool():
    """The JAX tool's globals after a run (it runs at import), its prints
    captured."""
    out = io.StringIO()
    with pltpu.force_tpu_interpret_mode(), contextlib.redirect_stdout(out):
        g = runpy.run_path(os.path.join(REPO, "tools", "debug_warp_kernel.py"))
    assert "flow_y max diff" in out.getvalue()
    return g


def test_plain_flow_stage_matches_the_tpu_bisect_kernel(jax_tool):
    """The TPU kernel's first five lanes against the plain version fed the
    tool's own coefficients and control points. Bounds: flow 2e-4 px
    (4.6e-5 measured: f32 sums in another order), qy and qx 1e-6 (6e-8),
    phi_0 1e-6 (2.7e-7: another log); the other 123 lanes are zero."""
    H, W = jax_tool["H"], jax_tool["W"]
    got = np.asarray(jax_tool["got"])
    assert got.shape == (2, H * W, 128)
    np.testing.assert_array_equal(got[..., 5:], 0.0)
    wv = torch.from_numpy(np.array(jax_tool["wv"]))
    cp = torch.from_numpy(np.array(jax_tool["cp_grid"]))
    ours = tps._tps_flow_stage_plain(wv, cp, (H, W)).numpy()
    assert ours.shape == (2, H * W, 5) and ours.dtype == np.float32
    err = np.abs(ours - got[..., :5]).max(axis=(0, 1))
    assert err[0] <= 2e-4 and err[1] <= 2e-4, err
    assert err[2] <= 1e-6 and err[3] <= 1e-6, err
    assert err[4] <= 1e-6, err


def _flow_float64(wv, cp, H, W):
    """The flow-stage dump in float64 numpy: (B, H*W, 5)."""
    wv, cp = wv.astype(np.float64), cp.astype(np.float64)
    q = np.arange(H * W)
    qy, qx = (q // W) / (H - 1.0), (q % W) / (W - 1.0)
    d2 = (qy[:, None] - cp[None, :, 0]) ** 2 + (qx[:, None] - cp[None, :, 1]) ** 2
    phi = 0.5 * d2 * np.log(np.maximum(d2, 1e-10))                  # (M, n)
    basis = np.concatenate([phi, qy[:, None], qx[:, None], np.ones((H * W, 1))], 1)
    flow = np.einsum("mk,bkd->bmd", basis, wv) * np.array([H - 1.0, W - 1.0])
    per_point = np.broadcast_to(np.stack([qy, qx, phi[:, 0]], -1), (wv.shape[0], H * W, 3))
    return np.concatenate([flow, per_point], -1)


@pytest.mark.parametrize("B,H,W", [(3, 33, 47), (3, 64, 64)])
def test_plain_flow_stage_against_float64(B, H, W):
    """At shapes that are not square or not a multiple of a block, with
    offsets of +-0.025 and +-0.3, against float64 on the same f32
    coefficients. The flow is an f32 sum of 25 terms of size |w| |phi|,
    so its roundoff grows with the coefficients (|w| ~1 at +-0.025, ~10
    at +-0.3): flow within 2e-5 and 1e-4 px (measured at most 1.0e-5 and
    5.3e-5), qy, qx and phi_0 within 1e-6."""
    r = np.random.RandomState(H)
    for scale, tol in ((0.05, 2e-5), (0.6, 1e-4)):
        off = ((r.rand(B, 25, 2) - 0.5) * scale).astype(np.float32)
        wv = tps.tps_coefficients(torch.from_numpy(off))
        cp = tps.control_grid((5, 5))
        got = tps._tps_flow_stage_plain(wv, cp, (H, W)).numpy()
        ref = _flow_float64(wv.numpy(), cp.numpy(), H, W)
        err = np.abs(got - ref).max(axis=(0, 1))
        assert err[0] <= tol and err[1] <= tol, (scale, err)
        assert err[2:].max() <= 1e-6, (scale, err)


def test_port_tool_on_the_cpu():
    """The port's tool, `--device cpu`: five finite numbers, the flow
    within 1e-3 px of tps_sample_locations (expanded-form distances and
    one matmul, against the kernel's direct differences term by term)."""
    before = cuda_kernels.launch_counts()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        diffs = debug_warp_kernel.main(["--device", "cpu"])
    assert sorted(diffs) == ["flow_x", "flow_y", "phi0", "qx", "qy"]
    assert all(np.isfinite(v) for v in diffs.values())
    assert diffs["flow_y"] <= 1e-3 and diffs["flow_x"] <= 1e-3, diffs
    assert max(diffs["qy"], diffs["qx"], diffs["phi0"]) <= 1e-6, diffs
    assert out.getvalue().count("max diff:") == 5
    assert cuda_kernels.launch_counts() == before


def test_port_tool_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        debug_warp_kernel.main([])
    assert e.value.code != 0


def test_flow_stage_on_the_cpu_never_reaches_the_kernels(monkeypatch):
    """A CPU tensor takes the plain version: neither the wrapper nor the
    library loader is touched."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path reached cuda_kernels")

    monkeypatch.setattr(tps, "tps_flow_dbg", refuse)
    monkeypatch.setattr(cuda_kernels, "tps_flow_dbg", refuse)
    monkeypatch.setattr(cuda_kernels, "_load", refuse)
    off = torch.from_numpy(((np.random.RandomState(2).rand(2, 25, 2) - 0.5) * 0.05)
                           .astype(np.float32))
    wv, cp = tps.tps_coefficients(off), tps.control_grid((5, 5))
    got = tps.tps_flow_stage(wv, cp, (24, 20))
    assert torch.equal(got, tps._tps_flow_stage_plain(wv, cp, (24, 20)))
    with pytest.raises(ValueError):
        tps.tps_flow_stage(wv.to("meta"), cp, (24, 20))


def test_flow_wrapper_rejects_a_cpu_tensor_before_building(monkeypatch):
    def refuse():
        raise AssertionError("built or loaded")

    monkeypatch.setattr(cuda_kernels, "_load", refuse)
    monkeypatch.setattr(cuda_kernels, "build_all", refuse)
    monkeypatch.setattr(cuda_kernels.TPS_FLOW_DBG, "fns", None)
    before = cuda_kernels.TPS_FLOW_DBG.launches
    wv = torch.zeros(2, 28, 2)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.tps_flow_dbg(wv, tps.control_grid((5, 5)), (8, 8))
    assert cuda_kernels.TPS_FLOW_DBG.launches == before


@pytest.mark.parametrize("name", sorted(os.listdir(cuda_kernels.CSRC_DIR)))
def test_a_newer_file_under_csrc_makes_the_library_stale(tmp_path, monkeypatch, name):
    """Every file under csrc/, the shared header tps_flow.cuh among them,
    is a dependency of the library: a copy of csrc/ older than a stand-in
    library is fresh until that one file is newer."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in os.listdir(cuda_kernels.CSRC_DIR):
        (csrc / f).write_text("")
        os.utime(csrc / f, (1000.0, 1000.0))
    lib = tmp_path / "lib.so"
    lib.write_text("")
    os.utime(lib, (2000.0, 2000.0))
    monkeypatch.setattr(cuda_kernels, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(cuda_kernels, "LIBRARY", str(lib))
    assert not cuda_kernels._stale()
    os.utime(csrc / name, (3000.0, 3000.0))
    assert cuda_kernels._stale()
    os.remove(lib)
    assert cuda_kernels._stale()
