"""Real-CHAOS dress rehearsal: fabricate a 20-volume CHAOS DICOM tree at the
real archive's file profile and run the port's CLI on it end to end.

Port of the JAX package's tools/dress_rehearsal.py. When a real CHAOS
dataset mounts, only MMSEG_TPU_CHAOS_DIR changes: this tool runs every step
after the filesystem on a tree with the archive's profile (per-volume raw
slice counts of 23-42 a modality, 256x288 implicit-VR 12-bit-in-16 DICOMs
with modality rescale (1, -1024), Ground PNGs at organ values
63/126/189/252): DICOM decode through the native reader, the 1.89 mm
resample, the curated alignment, the [-1, 1] rescale, the 192x192 crop,
split assembly, then `--config dafnet_config_chaos --split 0` through the
CLI with no --dataset override (train, validation, checkpoints, export,
test), then `--test` on the same folder, which must write the same Dice.

  python -m multimodal_segmentation_torch.tools.dress_rehearsal            # GPU
  python -m multimodal_segmentation_torch.tools.dress_rehearsal --device cpu --tiny \\
      --epochs 1 --steps-per-epoch 2

Flags: --root DIR (the tree, made afresh; default tmp/chaos_rehearsal/MR
in the repository, the CLI's folder beside it in run/), --epochs N,
--device cuda|cpu, --bf16 (--compute_dtype bfloat16), --l_mix f,
--steps-per-epoch N (cap an epoch), --tiny (the tiny test config's widths,
32x32, for a quick CPU run). It prints one JSON line: ingest seconds,
slices per split, DICOM files and native reads, the run's epoch parts and
test Dice.
"""

import argparse
import csv
import json
import os
import shutil
import struct
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ALL_VOLUMES = [1, 2, 3, 5, 8, 10, 13, 15, 19, 20, 21, 22, 31, 32, 33, 34, 36, 37, 38, 39]

# Raw slice counts (t1, t2) at CHAOS scale (MR volumes run ~26-50 slices),
# above every threshold of the hand-derived alignment table
RAW_COUNTS = {
    1: (30, 29), 2: (27, 26), 3: (30, 27), 5: (28, 26), 8: (35, 31),
    10: (42, 28), 13: (33, 32), 15: (26, 26), 19: (31, 28), 20: (25, 25),
    21: (23, 25), 22: (32, 27), 31: (27, 26), 32: (36, 34), 33: (34, 30),
    34: (31, 25), 36: (29, 26), 37: (36, 34), 38: (28, 28), 39: (26, 26),
}

# aligned pairs a volume gives at RAW_COUNTS, derived by hand from the
# reference's inline slicing (loaders/chaos.py:110-240); volumes 33 and 37
# grow with their raw counts: min(n1 - 12, n2 - 8) and
# min(14 + max(0, n1 - 25), 16 + max(0, n2 - 29))
EXPECTED_PAIRS = {
    1: 20, 2: 17, 3: 14, 5: 16, 8: 21, 10: 19, 13: 25, 15: 22, 19: 19, 20: 19,
    21: 16, 22: 17, 31: 16, 32: 27, 33: 22, 34: 19, 36: 17, 37: 21, 38: 15, 39: 19,
}

ROWS, COLS = 256, 288           # off-square: exercises resample + crop/pad
SPACING = (1.6, 1.6)            # CHAOS-like in-plane resolution (mm)
RESCALE = (1.0, -1024.0)        # modality LUT: slope, intercept
SPLIT_TYPES = ("training", "validation", "test")


def _ds(text):
    b = text.encode()
    return b + b" " if len(b) % 2 else b


def _element(group, elem, value):
    """Implicit-VR little-endian data element."""
    return struct.pack("<HHI", group, elem, len(value)) + value


def write_dicom(path, pixels, spacing=SPACING, bits_stored=12, high_bit=11,
                rescale=RESCALE, slice_spacing=7.7):
    """A DICOM Part-10 file as the CHAOS archive holds them: implicit VR
    little endian (with the explicit-VR file-meta group), 16 bits
    allocated, `bits_stored` of them stored up to `high_bit`, unsigned,
    with RescaleSlope/Intercept. `pixels`: (rows, cols) uint16."""
    pixels = np.asarray(pixels, dtype=np.uint16)
    rows, cols = pixels.shape
    body = b"".join((
        _element(0x0028, 0x0010, struct.pack("<H", rows)),
        _element(0x0028, 0x0011, struct.pack("<H", cols)),
        _element(0x0028, 0x0030, _ds("%g\\%g" % tuple(spacing))),
        _element(0x0018, 0x0088, _ds("%g" % slice_spacing)),
        _element(0x0028, 0x0100, struct.pack("<H", 16)),
        _element(0x0028, 0x0103, struct.pack("<H", 0)),
        _element(0x0028, 0x0101, struct.pack("<H", bits_stored)),
        _element(0x0028, 0x0102, struct.pack("<H", high_bit)),
        _element(0x0028, 0x1053, _ds("%g" % rescale[0])),
        _element(0x0028, 0x1052, _ds("%g" % rescale[1])),
        _element(0x7FE0, 0x0010, pixels.tobytes()),
    ))
    uid = b"1.2.840.10008.1.2\x00"  # implicit VR little endian
    meta = struct.pack("<HH2sH", 0x0002, 0x0010, b"UI", len(uid)) + uid
    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM" + meta + body)


def _organ_gt(slice_frac):
    """Ground PNG (ROWS x COLS) with 4 organ blobs whose positions drift
    slowly through the volume (aligned T1/T2 slices therefore correlate
    anatomically)."""
    gt = np.zeros((ROWS, COLS), np.uint8)
    dy = int(20 * slice_frac)
    gt[40 + dy:110 + dy, 40:140] = 63     # liver
    gt[130 + dy:170 + dy, 40:90] = 126    # right kidney
    gt[130 + dy:170 + dy, 150:200] = 189  # left kidney
    gt[50 + dy:100 + dy, 190:250] = 252   # spleen
    return gt


def fabricate_tree(root, shape=(ROWS, COLS)):
    """The 20-volume tree under `root` (T1DUAL/DICOM_anon/OutPhase with an
    empty InPhase sibling, T2SPIR/DICOM_anon, Ground PNGs), slices of
    `shape` (the archive's 256x288 unless a test asks for less; the organ
    map is sampled from the 256x288 one). Returns the number of DICOM
    files written."""
    from PIL import Image

    rows, cols = shape
    y, x = np.arange(rows, dtype=np.float64), np.arange(cols, dtype=np.float64)
    pick = np.ix_(np.arange(rows) * ROWS // rows, np.arange(cols) * COLS // cols)
    files = 0
    for v in ALL_VOLUMES:
        for modality, n in zip(("t1", "t2"), RAW_COUNTS[v]):
            if modality == "t1":
                folder = os.path.join(root, str(v), "T1DUAL")
                img_dir = os.path.join(folder, "DICOM_anon", "OutPhase")
                os.makedirs(os.path.join(folder, "DICOM_anon", "InPhase"), exist_ok=True)
            else:
                folder = os.path.join(root, str(v), "T2SPIR")
                img_dir = os.path.join(folder, "DICOM_anon")
            gt_dir = os.path.join(folder, "Ground")
            os.makedirs(img_dir, exist_ok=True)
            os.makedirs(gt_dir, exist_ok=True)
            r = np.random.RandomState(1000 * v + (0 if modality == "t1" else 1))
            for i in range(n):
                # smooth anatomy-like pattern + noise, 12-bit range
                base = 1800 + 1200 * np.outer(np.sin(y / 37.0 + v), np.cos(x / 29.0 + i / 7.0))
                pixels = np.clip(base + r.rand(rows, cols) * 400, 0, 4095).astype(np.uint16)
                write_dicom(os.path.join(img_dir, "IMG-0004-%05d.dcm" % (i + 1)), pixels)
                Image.fromarray(_organ_gt(i / max(1, n - 1))[pick]).save(
                    os.path.join(gt_dir, "IMG-0004-%05d.png" % (i + 1)))
                files += 1
    return files


def check_alignment():
    """Each volume's aligned pair count at RAW_COUNTS equals the table."""
    from multimodal_segmentation_torch.data.chaos_alignment import aligned_indices

    for v in ALL_VOLUMES:
        i1, i2 = aligned_indices(v, *RAW_COUNTS[v])
        if not len(i1) == len(i2) == EXPECTED_PAIRS[v]:
            raise AssertionError("volume %d: %d/%d aligned pairs, the table says %d"
                                 % (v, len(i1), len(i2), EXPECTED_PAIRS[v]))


def ingest(split=0):
    """Load split `split`'s three parts through init_loader('chaos') twice:
    cold (DICOM decode, resample, alignment; writes the .npz cache) and
    warm (from the cache). Checks the loader is a ChaosLoader, each part's
    aligned slices and 192x192 shape, and that the warm pass reads no
    DICOM and gives the same arrays. Returns the timings and counts."""
    from multimodal_segmentation_torch.data import dicom_native
    from multimodal_segmentation_torch.data.chaos import ChaosLoader
    from multimodal_segmentation_torch.data.loader_factory import init_loader

    out, arrays = {}, {}
    for name in ("cold", "warm"):
        loader = init_loader("chaos")
        if type(loader) is not ChaosLoader:
            raise AssertionError("init_loader('chaos') gave %s" % type(loader).__name__)
        reads = dicom_native.native_reads
        t0 = time.perf_counter()
        parts = {st: loader.load_all_modalities_concatenated(split, st) for st in SPLIT_TYPES}
        out["ingest_%s_s" % name] = time.perf_counter() - t0
        out["native_reads_%s" % name] = dicom_native.native_reads - reads
        arrays[name] = parts
    for st, data in arrays["cold"].items():
        want = sum(EXPECTED_PAIRS[v] for v in loader.splits()[split][st])
        if data.size() != want or data.get_images_modi(0).shape[1:] != (192, 192, 1):
            raise AssertionError("split %d %s: %d slices of %s, want %d of (192, 192, 1)" % (
                split, st, data.size(), data.get_images_modi(0).shape[1:], want))
        warm = arrays["warm"][st]
        if not all(np.array_equal(a(i), b(i)) for i in (0, 1) for a, b in (
                (data.get_images_modi, warm.get_images_modi),
                (data.get_masks_modi, warm.get_masks_modi))):
            raise AssertionError("split %d %s: the .npz cache gives other arrays" % (split, st))
    if out["native_reads_warm"]:
        raise AssertionError("the warm pass decoded %d DICOMs" % out["native_reads_warm"])
    out["slices"] = {st: arrays["cold"][st].size() for st in SPLIT_TYPES}
    out["data_folder"] = loader.data_folder
    return out


def _results(folder):
    out = {}
    for d in sorted(os.listdir(folder)):
        if d.startswith("test_results_"):
            with open(os.path.join(folder, d, "results.csv")) as f:
                out[d] = f.read()
    return out


def _mean_dice(text):
    rows = list(csv.reader(text.splitlines(), skipinitialspace=True))[1:]
    return sum(float(r[1]) for r in rows) / len(rows)


def rehearse(workdir, epochs, device, l_mix, bf16, steps_per_epoch, tiny):
    """The CLI on the tree (no --dataset override): train with validation,
    checkpoints and export, test; then `--test` on the same folder, which
    must write the same results. Returns what the run did."""
    from multimodal_segmentation_torch import experiment
    from multimodal_segmentation_torch.config import tiny_test_config

    flags = ["--config", "dafnet_config_chaos", "--split", "0", "--l_mix", str(l_mix),
             "--device", device]
    if bf16:
        flags += ["--compute_dtype", "bfloat16"]
    overrides = {"steps_per_epoch": steps_per_epoch}
    if tiny:
        t = tiny_test_config()
        overrides.update({k: getattr(t, k) for k in (
            "input_shape", "batch_size", "anatomy_encoder", "d_mask_params", "d_image_params")})
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    cwd = os.getcwd()
    try:
        os.chdir(workdir)
        t0 = time.perf_counter()
        ex = experiment.Experiment().run(flags + ["--epochs", str(epochs)], **overrides)
        run_s = time.perf_counter() - t0
        folder = os.path.join(workdir, ex.conf.folder)
        first = _results(folder)
        t0 = time.perf_counter()
        again = experiment.Experiment().run(flags + ["--epochs", str(epochs), "--test"],
                                            **overrides)
        test_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    with open(os.path.join(folder, "experiment_configuration.json")) as f:
        saved = json.load(f)
    with open(os.path.join(folder, "training.csv")) as f:
        rows = list(csv.DictReader(f))
    checks = {
        "dataset_name chaos": saved["dataset_name"] == saved["test_dataset"] == "chaos",
        "trained on the ChaosLoader": type(ex.loader).__name__ == "ChaosLoader",
        "tested on chaos": all(d.startswith("test_results_chaos_") for d in first),
        "epochs logged": len(rows) == epochs,
        "12 results.csv": len(first) == 12,
        "9 component files": len(os.listdir(os.path.join(folder, "models"))) == 9,
        "--test writes the same results": _results(folder) == first,
        "steps": ex.final_state.step == again.final_state.step > 0,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError("the CLI run's artifacts: %s" % failed)
    return {
        "folder": folder,
        "loader": type(ex.loader).__name__,
        "flags": flags,
        "overrides": sorted(overrides),
        "steps": ex.final_state.step,
        "batches_per_epoch": ex.batches,
        "epoch_seconds": ex.epoch_seconds,
        "run_s": run_s,
        "test_s": test_s,
        "dice": {d[len("test_results_"):]: _mean_dice(t) for d, t in first.items()},
        "training_csv_last": {k: float(v) for k, v in rows[-1].items()},
    }


def main(argv=None):
    """Fabricate, check the alignment, ingest and run the CLI. Returns the
    result dict it prints."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.join(REPO, "tmp", "chaos_rehearsal", "MR"))
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--l_mix", type=float, default=1.0)
    ap.add_argument("--steps-per-epoch", type=int, default=0)
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            sys.exit("dress_rehearsal: no CUDA device; pass --device cpu to run on the CPU")
    root = os.path.abspath(args.root)
    # the user's one setting; the loader reads it when its module is first
    # imported, so it must agree with what the loader holds
    os.environ["MMSEG_TPU_CHAOS_DIR"] = root
    from multimodal_segmentation_torch.data.base_loader import DATA_CONF

    if os.path.abspath(DATA_CONF["chaos"]) != root:
        sys.exit("dress_rehearsal: the CHAOS folder was read as %s before --root %s was "
                 "set; run the tool in a fresh process" % (DATA_CONF["chaos"], root))

    res = {"root": root, "volumes": len(ALL_VOLUMES)}
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    res["dicom_files"] = fabricate_tree(root)
    res["fabricate_s"] = time.perf_counter() - t0
    check_alignment()
    res.update(ingest())
    res["run"] = rehearse(os.path.join(os.path.dirname(root), "run"), args.epochs, args.device,
                          args.l_mix, args.bf16, args.steps_per_epoch, args.tiny)
    print(json.dumps({"dress_rehearsal": res}))
    return res


if __name__ == "__main__":
    main()
