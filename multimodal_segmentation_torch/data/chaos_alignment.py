"""Hand-curated CHAOS T1<->T2 slice-alignment table, ported as DATA.

The port's own copy of multimodal_segmentation_tpu/data/chaos_alignment.py
(tests/test_torch_chaos.py holds the two equal).

The reference encodes this alignment as inline numpy slicing per volume
(loaders/chaos.py:110-240). Here each volume maps to an ordered list of
selection operations applied alternately to the T1 and T2 slice-index
lists; each operation is ('t1'|'t2', [(start, stop), ...]) meaning
"replace that modality's current index list with the concatenation of
those python slices". This is load-bearing for the paired-training premise
(SURVEY.md §7 hard part 7) — do not edit without re-deriving from the
reference.
"""

ALIGNMENT_OPS = {
    1: [
        ("t2", [(1, None)]),
        ("t1", [(0, 26)]),
        ("t2", [(4, 24)]),
        ("t1", [(0, 5), (7, 10), (13, 17), (18, None)]),
    ],
    2: [
        ("t1", [(4, 7), (8, 23)]),
        ("t2", [(3, 22)]),
        ("t1", [(0, 11), (12, 18)]),
        ("t2", [(0, 11), (12, 18)]),
    ],
    3: [
        ("t1", [(11, 14), (15, 26)]),
        ("t2", [(9, 23)]),
    ],
    5: [
        ("t1", [(4, 5), (8, 24)]),
        ("t2", [(2, 22)]),
        ("t2", [(0, 6), (9, None)]),
        ("t1", [(0, 8), (9, None)]),
        ("t2", [(0, 8), (9, None)]),
    ],
    8: [
        ("t1", [(2, -2)]),
        ("t1", [(5, 11), (12, 27)]),
        ("t2", [(6, 27)]),
    ],
    10: [
        ("t1", [(14, 38)]),
        ("t2", [(5, 24)]),
        ("t1", [(0, 8), (12, 18), (19, None)]),
    ],
    13: [
        ("t1", [(4, 29)]),
        ("t2", [(3, 28)]),
    ],
    15: [
        ("t1", [(None, 22)]),
        ("t2", [(None, 22)]),
    ],
    19: [
        ("t1", [(8, 27)]),
        ("t2", [(5, 24)]),
    ],
    20: [
        ("t1", [(2, 21)]),
        ("t2", [(2, 21)]),
    ],
    21: [
        ("t1", [(3, 19)]),
        ("t2", [(5, 21)]),
    ],
    22: [
        ("t1", [(None, -2)]),
        ("t1", [(8, 17), (18, 26)]),
        ("t2", [(3, 12), (15, 23)]),
    ],
    31: [
        ("t1", [(7, 23)]),
        ("t2", [(5, 12), (13, 22)]),
    ],
    32: [
        ("t1", [(5, 32)]),
        ("t2", [(3, 30)]),
    ],
    33: [
        ("t1", [(7, -5)]),
        ("t2", [(3, 12), (15, -2)]),
    ],
    34: [
        ("t1", [(1, 2), (3, 4), (5, 6), (7, 27)]),
        ("t1", [(0, 14), (15, 16), (17, 18), (19, 22), (23, 24)]),
        ("t2", [(2, 21)]),
    ],
    36: [
        ("t1", [(8, 25)]),
        ("t2", [(4, 6), (7, 22)]),
    ],
    37: [
        ("t1", [(9, 23), (24, -1)]),
        ("t2", [(4, 6), (7, 21), (22, -7)]),
    ],
    38: [
        ("t1", [(9, 24)]),
        ("t2", [(9, 24)]),
    ],
    39: [
        ("t1", [(3, 22)]),
        ("t2", [(3, 22)]),
    ],
}


def aligned_indices(volume, n_t1, n_t2):
    """Apply the alignment ops for `volume` to index arrays of the raw slice
    counts; returns (t1_indices, t2_indices) into the raw volumes."""
    import numpy as np

    idx = {"t1": np.arange(n_t1), "t2": np.arange(n_t2)}
    for mod, slices in ALIGNMENT_OPS.get(volume, []):
        cur = idx[mod]
        idx[mod] = np.concatenate([cur[slice(a, b)] for a, b in slices])
    # Python-slice clipping means final lengths depend on the raw slice
    # counts; pair up to the common length (the reference would fail the
    # channel-concat otherwise).
    n = min(len(idx["t1"]), len(idx["t2"]))
    return idx["t1"][:n], idx["t2"][:n]
