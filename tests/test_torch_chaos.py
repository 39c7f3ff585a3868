"""The port's real-CHAOS data path against the JAX package's, on the CPU: the
native DICOM reader (the nine cases of tests/test_native.py, each decoded
to the same image and resolution by both packages), the reader's source,
the CHAOS loader on a fabricated tree (images, masks and index equal, both
modality orders, the .npz cache), the alignment table, and the dress
rehearsal's DICOM writer, tables and CLI run at a small slice size."""

import os
import shutil

import numpy as np
import pytest
import torch

from multimodal_segmentation_tpu.data import chaos as jchaos
from multimodal_segmentation_tpu.data import chaos_alignment as jalign
from multimodal_segmentation_tpu.data import dicom_native as jdicom
from multimodal_segmentation_torch.data import base_loader
from multimodal_segmentation_torch.data import chaos as tchaos
from multimodal_segmentation_torch.data import chaos_alignment as talign
from multimodal_segmentation_torch.data import dicom_native as tdicom
from multimodal_segmentation_torch.tools import dress_rehearsal
from tests.test_chaos_alignment_lock import FIXED_COUNTS, OPEN_FORMS
from tests.test_chaos_ingest import _make_volume
from tests.test_native import make_dicom

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None, reason="g++ not available (native reader)"
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_native.py's cases: make_dicom's arguments
READER_CASES = {
    "explicit_vr": {},
    "implicit_vr": {"rows": 5, "cols": 6, "implicit": True},
    "8bit": {"rows": 2, "cols": 2, "bits": 8},
    "12bit_in_16_overlay": {"rows": 2, "cols": 2, "bits_stored": 12, "high_bit": 11,
                            "pixels": np.array([0, 1, 4095, 0xF000 | 7], np.uint16)},
    "rescale": {"rescale": (2.5, -100.0)},
    "signed": {"rows": 2, "cols": 2, "signed": True, "bits_stored": 12, "high_bit": 11,
               "pixels": np.array([0, 1, 4095, 2048], np.uint16)},
    "implicit_12bit_rescale": {"rows": 3, "cols": 4, "implicit": True, "bits_stored": 12,
                               "high_bit": 11, "rescale": (1.5, 10.0),
                               "pixels": (np.arange(12, dtype=np.uint16) * 300) % 4096},
}


@pytest.mark.parametrize("case", sorted(READER_CASES) + ["missing_file", "read_dicom"])
def test_native_reader_matches_jax(case, tmp_path):
    """Image and resolution equal to the JAX reader's on the same file, and
    the image equal to what make_dicom encoded; a missing file raises
    IOError in both."""
    p = str(tmp_path / "a.dcm")
    if case == "missing_file":
        for reader in (jdicom.NativeDicom, tdicom.NativeDicom):
            with pytest.raises(IOError):
                reader(p)
        return
    expected = make_dicom(p, **READER_CASES.get(case, {}))
    if case == "read_dicom":
        ref, got = jdicom.read_dicom(p), tdicom.read_dicom(p)
    else:
        ref, got = jdicom.NativeDicom(p), tdicom.NativeDicom(p)
    assert got.image.dtype == ref.image.dtype == np.float32
    np.testing.assert_array_equal(got.image, ref.image)
    assert got.resolution == ref.resolution
    np.testing.assert_allclose(got.image, expected)


def test_reader_source_is_the_jax_packages_byte_for_byte():
    with open(os.path.join(REPO, "native", "mmseg_dicom.cpp"), "rb") as f:
        ref = f.read()
    with open(tdicom.SRC, "rb") as f:
        assert f.read() == ref
    assert tdicom.SRC.startswith(os.path.join(REPO, "multimodal_segmentation_torch", ""))
    assert tdicom.BUILD_DIR == os.path.join(REPO, "multimodal_segmentation_torch", "build")


def test_reader_builds_under_its_pid_and_renames(tmp_path, monkeypatch):
    """The library is compiled to a file named with the building process's
    pid and renamed into place: nothing else is left in the build folder,
    and no process loads a half-written library."""
    calls = []
    real = tdicom.subprocess.check_call
    monkeypatch.setattr(tdicom.subprocess, "check_call",
                        lambda cmd: calls.append(cmd) or real(cmd))
    monkeypatch.setattr(tdicom, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tdicom, "LIBRARY", str(tmp_path / "build" / "libmmseg_dicom.so"))
    tdicom._build()
    (cmd,) = calls
    assert cmd[cmd.index("-o") + 1].endswith(".%d.tmp" % os.getpid())
    assert os.listdir(tmp_path / "build") == ["libmmseg_dicom.so"]


@pytest.fixture(scope="module")
def chaos_tree(tmp_path_factory):
    """tests/test_chaos_ingest.py's tree: volumes 15 and 20, 100x110
    implicit-VR 12-bit DICOMs at 2 mm with rescale, Ground PNGs."""
    root = str(tmp_path_factory.mktemp("chaos_mr"))
    for vol, n1, n2, seed in ((15, 24, 23, 0), (20, 24, 24, 1)):
        _make_volume(root, vol, "t1", n1, seed)
        _make_volume(root, vol, "t2", n2, seed + 100)
    return root


def _tiny(cls):
    class TinyChaos(cls):
        def splits(self):
            return [{"training": [15, 20], "validation": [15], "test": [20]}]

    return TinyChaos


@pytest.mark.parametrize("modalities", [["t1", "t2"], ["t2", "t1"]])
def test_chaos_loader_matches_jax(chaos_tree, tmp_path, modalities):
    """Every split's images, masks and index equal to the JAX loader's
    (np.array_equal), in either modality order."""
    ref_loader = _tiny(jchaos.ChaosLoader)(data_folder=chaos_tree, cache_dir=str(tmp_path / "j"))
    loader = _tiny(tchaos.ChaosLoader)(data_folder=chaos_tree, cache_dir=str(tmp_path / "t"))
    assert loader.available() and loader.splits() == ref_loader.splits()
    for ld in (ref_loader, loader):
        ld.modalities = list(modalities)
    for split_type in ("training", "validation", "test"):
        ref = ref_loader.load_all_modalities_concatenated(0, split_type)
        got = loader.load_all_modalities_concatenated(0, split_type)
        np.testing.assert_array_equal(got.index, ref.index)
        for i in (0, 1):
            assert got.get_images_modi(i).dtype == ref.get_images_modi(i).dtype
            np.testing.assert_array_equal(got.get_images_modi(i), ref.get_images_modi(i))
            np.testing.assert_array_equal(got.get_masks_modi(i), ref.get_masks_modi(i))
    assert got.get_images_modi(0).shape == (19, 192, 192, 1)  # test: volume 20's 19 pairs


def test_chaos_cache_round_trip_identical(chaos_tree, tmp_path):
    """A second loader reads the first one's .npz cache (no DICOM read) and
    gives the same arrays; the real splits and volumes are the JAX
    loader's."""
    cache = str(tmp_path / "cache")
    cold = _tiny(tchaos.ChaosLoader)(data_folder=chaos_tree, cache_dir=cache)
    a = cold.load_all_modalities_concatenated(0, "training")
    reads = tdicom.native_reads
    b = _tiny(tchaos.ChaosLoader)(data_folder=chaos_tree,
                                  cache_dir=cache).load_all_modalities_concatenated(0, "training")
    assert tdicom.native_reads == reads
    for i in (0, 1):
        np.testing.assert_array_equal(a.get_images_modi(i), b.get_images_modi(i))
        np.testing.assert_array_equal(a.get_masks_modi(i), b.get_masks_modi(i))
    np.testing.assert_array_equal(a.index, b.index)
    full, ref = tchaos.ChaosLoader(data_folder=chaos_tree), jchaos.ChaosLoader(data_folder=chaos_tree)
    assert full.splits() == ref.splits() and full.volumes == ref.volumes
    assert full.cache_dir == ref.cache_dir and full.input_shape == ref.input_shape


def test_data_conf_reads_the_jax_packages_variable():
    from multimodal_segmentation_tpu.data import base_loader as jbase

    assert base_loader.DATA_CONF == jbase.DATA_CONF


@pytest.mark.parametrize("volume", dress_rehearsal.ALL_VOLUMES)
def test_alignment_matches_jax(volume):
    """aligned_indices equal to JAX's at the locked table's raw counts
    (tests/test_chaos_alignment_lock.py: the minima and above for the
    fixed volumes, the closed-form grid for 33 and 37)."""
    assert talign.ALIGNMENT_OPS[volume] == jalign.ALIGNMENT_OPS[volume]
    if volume in FIXED_COUNTS:
        _, n1, n2 = FIXED_COUNTS[volume]
        counts = [(n1 + e, n2 + e) for e in (0, 1, 5, 20)]
    else:
        counts = [(n1, n2) for n1 in range(28, 45, 3) for n2 in range(28, 45, 3)]
    for n1, n2 in counts:
        got, ref = talign.aligned_indices(volume, n1, n2), jalign.aligned_indices(volume, n1, n2)
        for g, r in zip(got, ref, strict=True):
            np.testing.assert_array_equal(g, r)
        want = FIXED_COUNTS[volume][0] if volume in FIXED_COUNTS else OPEN_FORMS[volume](n1, n2)
        assert len(got[0]) == want


def test_dress_rehearsal_tables_match_the_jax_tool_and_the_locked_counts():
    from tools import dress_rehearsal as jtool

    assert dress_rehearsal.ALL_VOLUMES == jtool.ALL_VOLUMES
    assert dress_rehearsal.RAW_COUNTS == jtool.RAW_COUNTS
    assert (dress_rehearsal.ROWS, dress_rehearsal.COLS) == (jtool.ROWS, jtool.COLS)
    for v, (n1, n2) in dress_rehearsal.RAW_COUNTS.items():
        want = FIXED_COUNTS[v][0] if v in FIXED_COUNTS else OPEN_FORMS[v](n1, n2)
        assert dress_rehearsal.EXPECTED_PAIRS[v] == want, v
    dress_rehearsal.check_alignment()


@pytest.mark.parametrize("rows,cols", [(256, 288), (3, 5)])
def test_dress_rehearsal_writer_decodes_as_the_jax_reader(tmp_path, rows, cols):
    """The tool's DICOM writer (implicit VR, 12 bits in 16, rescale
    (1, -1024)) gives a file the JAX reader decodes to the same image as
    tests/test_native.py's make_dicom does for the same pixels, with the
    overlay bits masked off."""
    r = np.random.RandomState(rows)
    pixels = (r.rand(rows, cols) * 65535).astype(np.uint16)
    p, q = str(tmp_path / "tool.dcm"), str(tmp_path / "ref.dcm")
    dress_rehearsal.write_dicom(p, pixels)
    expected = make_dicom(q, rows=rows, cols=cols, spacing=dress_rehearsal.SPACING,
                          implicit=True, bits_stored=12, high_bit=11,
                          rescale=dress_rehearsal.RESCALE, pixels=pixels)
    got = jdicom.NativeDicom(p)
    np.testing.assert_array_equal(got.image, jdicom.NativeDicom(q).image)
    np.testing.assert_array_equal(got.image, expected)
    assert got.resolution == (1.6, 1.6, 7.7)
    np.testing.assert_array_equal(tdicom.read_dicom(p).image, got.image)


def test_dress_rehearsal_cli_trains_and_tests_on_a_fabricated_tree(tmp_path, monkeypatch):
    """The 20-volume tree at the archive's slice counts (slices of 48x54 to
    keep it small), MMSEG_TPU_CHAOS_DIR pointing at it, then the tool's
    steps: alignment, ingest (every DICOM through the native reader once,
    the warm pass from the cache), and the CLI at the tiny widths with no
    --dataset override: one epoch of 2 steps at l_mix 0.5, validation,
    checkpoint, export and test through the ChaosLoader, then `--test`
    with the same results."""
    root = str(tmp_path / "MR")
    monkeypatch.setenv("MMSEG_TPU_CHAOS_DIR", root)
    monkeypatch.setitem(base_loader.DATA_CONF, "chaos", root)
    files = dress_rehearsal.fabricate_tree(root, shape=(48, 54))
    assert files == sum(sum(c) for c in dress_rehearsal.RAW_COUNTS.values())
    dress_rehearsal.check_alignment()
    ing = dress_rehearsal.ingest()
    assert ing["native_reads_cold"] == files and ing["native_reads_warm"] == 0
    assert ing["slices"] == {"training": 268, "validation": 58, "test": 55}
    run = dress_rehearsal.rehearse(str(tmp_path / "run"), 1, "cpu", 0.5, False, 2, True)
    assert run["folder"].endswith("dafnet_chaos_l05_t1_t2_split0")
    assert run["loader"] == "ChaosLoader"
    assert run["steps"] == 4 and run["batches_per_epoch"] == 2  # both l_mix halves
    assert "--dataset" not in run["flags"]
    assert len(run["dice"]) == 12 and all(0 <= d <= 1 for d in run["dice"].values())
