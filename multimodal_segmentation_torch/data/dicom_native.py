"""ctypes bridge to the native C++ DICOM reader (native/mmseg_dicom.cpp).

The port's own copy of multimodal_segmentation_tpu/data/dicom_native.py,
reading the port's own copy of the source
(multimodal_segmentation_torch/native/mmseg_dicom.cpp). The shared library
is built with g++ on first use into multimodal_segmentation_torch/build/,
and rebuilt when the source is newer. It is written under the building
process's pid and renamed into place, so processes that build at the same
time never load a half-written file. Read order used by the CHAOS loader:
pydicom if installed, else this native reader.
"""

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

log = logging.getLogger("dicom_native")

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "native", "mmseg_dicom.cpp")
BUILD_DIR = os.path.join(_PKG, "build")
LIBRARY = os.path.join(BUILD_DIR, "libmmseg_dicom.so")

_lib = None
_lock = threading.Lock()
# files decoded by the native reader in this process (the CHAOS path's
# check that every slice went through it)
native_reads = 0


def _build():
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (LIBRARY, os.getpid())
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, SRC]
    log.info("Building native DICOM reader: %s", " ".join(cmd))
    subprocess.check_call(cmd)
    os.replace(tmp, LIBRARY)


def get_lib():
    global _lib
    with _lock:
        if _lib is None:
            if (not os.path.exists(LIBRARY)
                    or os.path.getmtime(LIBRARY) < os.path.getmtime(SRC)):
                _build()
            lib = ctypes.CDLL(LIBRARY)
            lib.mmseg_dicom_read.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_uint16),
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
            ]
            lib.mmseg_dicom_read.restype = ctypes.c_int
            _lib = lib
    return _lib


def _decode_stored_values(raw, bits_alloc, pixrep, bits_stored, high_bit,
                          slope, intercept):
    """Stored uint16 words -> modality (float32) values.

    * 12-bit-in-16 pixels: stored bits occupy [high_bit-bits_stored+1,
      high_bit]; shift them down and mask off any overlay/unused bits.
    * PixelRepresentation=1: two's-complement sign extension at
      bits_stored width (not the allocated width).
    * RescaleSlope/Intercept: the modality LUT, value = raw*slope + b.
      (The reference reads pydicom pixel_array and never applies it,
      loaders/dcm_contour_utils.py:27, but the CHAOS pipeline rescales
      every slice to [-1, 1] afterwards, chaos.py:242-243, so for slope > 0
      the model sees the same inputs either way.)
    """
    v = raw.astype(np.int64)
    if bits_stored < bits_alloc or high_bit != bits_stored - 1:
        shift = high_bit + 1 - bits_stored
        v = (v >> shift) & ((1 << bits_stored) - 1)
    if pixrep == 1:
        sign = 1 << (bits_stored - 1)
        v = np.where(v >= sign, v - (1 << bits_stored), v)
    return (v.astype(np.float32) * np.float32(slope)) + np.float32(intercept)


class NativeDicom:
    """Parsed DICOM slice: .image (float32 HxW) and .resolution
    (row, col, slice spacing in mm), the attributes the CHAOS pipeline
    consumes (reference loaders/dcm_contour_utils.py:9-34)."""

    MAX_PIXELS = 1024 * 1024

    def __init__(self, path):
        global native_reads
        lib = get_lib()
        pixels = np.zeros(self.MAX_PIXELS, dtype=np.uint16)
        meta = np.zeros(6, dtype=np.int32)
        spacing = np.zeros(3, dtype=np.float64)
        rescale = np.zeros(2, dtype=np.float64)
        rc = lib.mmseg_dicom_read(
            path.encode(),
            pixels.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            self.MAX_PIXELS,
            meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            spacing.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            rescale.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
        if rc != 0:
            raise IOError("native DICOM read failed (%d): %s" % (rc, path))
        rows, cols, bits, pixrep, bits_stored, high_bit = (int(x) for x in meta)
        img = pixels[: rows * cols].reshape(rows, cols)
        self.image = _decode_stored_values(
            img, bits, pixrep, bits_stored, high_bit,
            float(rescale[0]), float(rescale[1]),
        )
        self.resolution = (float(spacing[0]), float(spacing[1]), float(spacing[2]))
        native_reads += 1


def read_dicom(path):
    """pydicom when available, else the native reader."""
    try:
        import pydicom  # type: ignore
    except ImportError:
        return NativeDicom(path)
    ds = pydicom.dcmread(path)
    out = NativeDicom.__new__(NativeDicom)
    img = ds.pixel_array.astype(np.float32)
    # modality LUT, same as the native path (_decode_stored_values)
    slope = float(getattr(ds, "RescaleSlope", 1.0))
    intercept = float(getattr(ds, "RescaleIntercept", 0.0))
    out.image = img * np.float32(slope) + np.float32(intercept)
    sp = [float(v) for v in ds.PixelSpacing]
    sbs = float(getattr(ds, "SpacingBetweenSlices", 1.0))
    out.resolution = (sp[0], sp[1], sbs)
    return out
