"""Native batch activity accumulator vs the Python oracle.

Randomized reads with soft clips, indels, adaptor-overlapping short-insert
pairs, and contig-edge placements must produce identical histograms and
hq-softclip statistics through native/activity.cpp and through the per-read
Python accumulate_read loop (the oracle)."""

import numpy as np
import pytest

from rovaca_tpu.pipeline import activity as act
from rovaca_tpu.native import activity_native
from rovaca_tpu.reads.record import ReadRecord

pytestmark = pytest.mark.skipif(not activity_native.available(),
                                reason="native toolchain unavailable")

RNG = np.random.default_rng(20260820)
REF = bytes(RNG.choice(list(b"ACGT"), size=2000).tolist())


def window(start, end):
    L = end - start
    return act.ActivityWindow(
        start=start, end=end,
        hist=np.zeros((2, L, act.MAX_QUAL_BIN), dtype=np.int32),
        hq_sum=np.zeros(L), hq_n=np.zeros(L, dtype=np.int64))


def random_read(rng, i):
    pos = int(rng.integers(0, 1900))
    # build a random cigar: optional lead S, 1-3 aligned blocks separated
    # by I/D, optional trail S
    parts = []
    qlen = 0
    if rng.random() < 0.35:
        s = int(rng.integers(1, 20))
        parts.append((4, s))
        qlen += s
    blocks = int(rng.integers(1, 4))
    for b in range(blocks):
        m = int(rng.integers(1, 40))
        parts.append((0, m))
        qlen += m
        if b < blocks - 1:
            if rng.random() < 0.5:
                d = int(rng.integers(1, 8))
                parts.append((2, d))
            else:
                ins = int(rng.integers(1, 8))
                parts.append((1, ins))
                qlen += ins
    if rng.random() < 0.35:
        s = int(rng.integers(1, 20))
        parts.append((4, s))
        qlen += s
    bases = bytes(rng.choice(list(b"ACGT"), size=qlen).tolist())
    quals = rng.integers(2, 60, size=qlen).astype(np.uint8)
    flag = 0x1 | 0x2  # paired, proper
    rev = rng.random() < 0.5
    if rev:
        flag |= 0x10
    else:
        flag |= 0x20
    # short inserts sometimes => adaptor masking paths
    tlen = int(rng.integers(-120, 120))
    if rev:
        tlen = -abs(tlen)
    mate_pos = pos + (abs(tlen) - qlen if not rev else -(abs(tlen) - qlen))
    mate_pos = max(0, mate_pos)
    cigar = "".join(f"{n}{'MIDNSHP=X'[op]}" for op, n in parts)
    return ReadRecord(name=f"r{i}", flag=flag, ref_id=0, pos=pos,
                      mapping_quality=60, cigar=cigar, bases=bases,
                      quals=quals, mate_pos=mate_pos, tlen=tlen,
                      contig="chr1")


def assert_windows_equal(a, b):
    np.testing.assert_array_equal(a.hist, b.hist)
    np.testing.assert_array_equal(a.hq_n, b.hq_n)
    np.testing.assert_allclose(a.hq_sum, b.hq_sum, rtol=0, atol=0)


def test_randomized_reads_match_oracle():
    rng = np.random.default_rng(7)
    reads = [random_read(rng, i) for i in range(400)]
    w_native = window(0, 2000)
    activity_native.accumulate(w_native, reads,
                               np.frombuffer(REF, dtype=np.uint8), 0)
    w_py = window(0, 2000)
    for r in reads:
        act.accumulate_read(w_py, r, REF)
    assert_windows_equal(w_native, w_py)


def test_window_clamp_and_ref_view():
    """Window smaller than read span + ref view with an offset."""
    rng = np.random.default_rng(8)
    reads = [random_read(rng, i) for i in range(200)]
    # window [500, 900), ref view covering [400, 1400) only
    ref_view = np.frombuffer(REF[400:1400], dtype=np.uint8)
    w_native = window(500, 900)
    activity_native.accumulate(w_native, reads, ref_view, 400)

    class _View:
        offset = 400
        data = REF[400:1400]

        def __getitem__(self, sl):
            return REF[sl.start:sl.stop]

    w_py = window(500, 900)
    for r in reads:
        # oracle needs the same masked-ref semantics: positions outside
        # the view are dropped; replicate via the batch python path with
        # native disabled
        pass
    import os
    os.environ["ROVACA_NO_NATIVE_ACTIVITY"] = "1"
    try:
        act.accumulate_reads(w_py, reads, _View())
    finally:
        del os.environ["ROVACA_NO_NATIVE_ACTIVITY"]
    assert_windows_equal(w_native, w_py)


def test_contig_edge_pairs():
    """Overlapping soft-clipped mates at contig start/end (where the
    round-3 outputs diverged)."""
    reads = []
    # mate at contig start: adaptor boundary can be 0
    reads.append(ReadRecord(name="e0", flag=0x1 | 0x2 | 0x10, ref_id=0,
                            pos=5, mapping_quality=60, cigar="10S30M",
                            bases=bytes(REF[0:40]),
                            quals=np.full(40, 35, np.uint8),
                            mate_pos=0, tlen=-35, contig="chr1"))
    # pair ending at the contig tail with read-through soft clips
    reads.append(ReadRecord(name="e1", flag=0x1 | 0x2 | 0x20, ref_id=0,
                            pos=1960, mapping_quality=60, cigar="30M10S",
                            bases=bytes(REF[1960:2000]),
                            quals=np.full(40, 35, np.uint8),
                            mate_pos=1955, tlen=45, contig="chr1"))
    reads.append(ReadRecord(name="e1m", flag=0x1 | 0x2 | 0x10, ref_id=0,
                            pos=1955, mapping_quality=60, cigar="10S30M5S",
                            bases=bytes(REF[1945:1990]),
                            quals=np.full(45, 35, np.uint8),
                            mate_pos=1960, tlen=-45, contig="chr1"))
    w_native = window(0, 2000)
    activity_native.accumulate(w_native, reads,
                               np.frombuffer(REF, dtype=np.uint8), 0)
    w_py = window(0, 2000)
    for r in reads:
        act.accumulate_read(w_py, r, REF)
    assert_windows_equal(w_native, w_py)
