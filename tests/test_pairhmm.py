"""PairHMM correctness: golden scalar vs XLA vs the native host engine."""

import numpy as np
import pytest

from rovaca_tpu import constants as C
from rovaca_tpu.ops import gatk_math
from rovaca_tpu.ops.pairhmm import api, golden, prep
from rovaca_tpu.ops.pairhmm.xla import pairhmm_xla

from conftest import FakeRead, random_read, mutate


def make_case(rng, n_reads=5, n_haps=3, read_len=40, hap_len=60):
    ref = "".join(rng.choice(list("ACGT"), size=hap_len))
    haps = [ref] + [mutate(ref, rng, n_snp=2) for _ in range(n_haps - 2)] + [
        mutate(ref, rng, n_snp=1, n_ins=1, n_del=1)]
    haps = haps[:n_haps]
    reads = []
    for k in range(n_reads):
        start = int(rng.integers(0, max(1, hap_len - read_len)))
        frag = mutate(ref[start:start + read_len], rng, n_snp=1)
        quals = rng.integers(10, 40, size=len(frag))
        reads.append(FakeRead(frag, quals, mapping_quality=60))
    return reads, haps


def golden_matrix(reads, haps, dtype=np.float32):
    out = np.zeros((len(haps), len(reads)), dtype=dtype)
    for h, hap in enumerate(haps):
        for r, read in enumerate(reads):
            out[h, r] = golden.compute_full_prob(
                read.bases, read.quals, read.mapping_quality, hap, dtype=dtype)
    return out


class TestTables:
    def test_ph2pr(self):
        t = gatk_math.ph2pr_table(np.float64)
        assert t[0] == 1.0
        assert np.isclose(t[10], 0.1)
        assert np.isclose(t[30], 1e-3)

    def test_match_to_match_symmetric_and_bounded(self):
        m = gatk_math.match_to_match_table(np.float32)
        assert m.shape == (128, 128)
        assert np.allclose(m, m.T)
        assert np.isclose(m[45, 45], 1.0 - 2 * 10 ** -4.5, rtol=1e-3)
        # high quals sum to ~0 -> mm ~ 1
        assert m[127, 127] > 0.999

    def test_log10_sum_log10(self):
        vals = np.array([-1.0, -2.0, -3.0])
        expected = np.log10(np.sum(10.0 ** vals))
        assert np.isclose(gatk_math.log10_sum_log10(vals, axis=0), expected)


class TestGolden:
    def test_perfect_match_likelihood(self):
        # a read identical to the hap should have likelihood ~ sum of qual errs
        hap = "ACGTACGTACGTACGTACGT"
        read = FakeRead(hap, [30] * len(hap), mapping_quality=60)
        ll = golden.log10_likelihood(read.bases, read.quals,
                                     read.mapping_quality, hap)
        # rough bound: each base contributes log10(1-1e-3); alignment has
        # 1/hap_len start factor
        assert -3.0 < ll < 0.0

    def test_mismatches_lower_likelihood(self, rng):
        hap = "".join(rng.choice(list("ACGT"), size=50))
        read0 = hap[5:45]
        read2 = mutate(read0, rng, n_snp=3)
        q = [35] * 40
        ll0 = golden.log10_likelihood(read0.encode(), q, 60, hap)
        ll2 = golden.log10_likelihood(read2.encode(), q, 60, hap)
        assert ll0 > ll2

    def test_float_vs_double_close(self, rng):
        reads, haps = make_case(rng)
        gf = golden_matrix(reads, haps, np.float32)
        gd = golden_matrix(reads, haps, np.float64)
        lf = np.log10(gf.astype(np.float64)) - C.LOG10_INITIAL_CONSTANT_F32
        ld = np.log10(gd) - C.LOG10_INITIAL_CONSTANT_F64
        np.testing.assert_allclose(lf, ld, atol=1e-3)

    def test_n_bases_match_everything(self):
        hap = "ACGTN"
        read = FakeRead("NNNNN", [30] * 5, 60)
        ll = golden.log10_likelihood(read.bases, read.quals, 60, hap)
        assert ll > -2.0


class TestXlaVsGolden:
    @pytest.mark.parametrize("n_reads,n_haps,read_len,hap_len", [
        (3, 2, 20, 30),
        (7, 5, 45, 70),
        (1, 1, 10, 10),
    ])
    def test_matches_golden_f32(self, rng, n_reads, n_haps, read_len, hap_len):
        reads, haps = make_case(rng, n_reads, n_haps, read_len, hap_len)
        batch = prep.build_pair_batch(reads, haps)
        raw = np.asarray(pairhmm_xla(batch.trans, batch.rbase, batch.rlen,
                                     batch.hbase, batch.hlen))
        got = batch.result_matrix(raw)
        want = golden_matrix(reads, haps, np.float32)
        np.testing.assert_allclose(got, want, rtol=2e-4)

    def test_varied_lengths(self, rng):
        # reads and haps of many different lengths exercise both masks
        hap_lens = [17, 31, 60, 44, 25, 50, 38, 29, 61]
        haps = ["".join(rng.choice(list("ACGT"), size=L)) for L in hap_lens]
        reads = [random_read(rng, L) for L in (8, 15, 22, 37, 40, 11)]
        batch = prep.build_pair_batch(reads, haps)
        raw = np.asarray(pairhmm_xla(batch.trans, batch.rbase, batch.rlen,
                                     batch.hbase, batch.hlen))
        got = batch.result_matrix(raw)
        want = golden_matrix(reads, haps, np.float32)
        np.testing.assert_allclose(got, want, rtol=2e-4)


class TestApi:
    def test_compute_likelihoods_shapes(self, rng):
        reads, haps = make_case(rng, n_reads=6, n_haps=4)
        lik, kept = api.compute_likelihoods(reads, haps, engine="xla")
        assert lik.shape == (4, len(kept))
        assert np.all(lik <= 0.0)

    def test_normalization_cap(self):
        lik = np.array([[0.0, -3.0, -20.0]])
        out = api.normalize_likelihoods(lik)
        np.testing.assert_allclose(out, [[0.0, -3.0, -4.5]])

    def test_poorly_modelled_filter(self, rng):
        # a garbage read (all mismatches at high qual) must be dropped
        hap = "".join(rng.choice(list("ACGT"), size=60))
        good = FakeRead(hap[5:45], [35] * 40, 60)
        trans = {"A": "C", "C": "G", "G": "T", "T": "A"}
        garbage = FakeRead("".join(trans[b] for b in hap[5:45]), [35] * 40, 60)
        lik, kept = api.compute_likelihoods([good, garbage], [hap],
                                            engine="xla")
        assert list(kept) == [0]

    def test_rescue_path(self):
        # a long high-qual read of pure mismatches underflows float32
        hap = "A" * 300
        read = FakeRead("C" * 280, [40] * 280, 60)
        raw = np.array([[0.0]], dtype=np.float32)  # simulate underflow
        out = api.log10_with_rescue(raw, [read], [hap])
        want = golden.compute_full_prob(read.bases, read.quals, 60, hap,
                                        dtype=np.float64)
        np.testing.assert_allclose(
            out[0, 0], np.log10(want) - C.LOG10_INITIAL_CONSTANT_F64)


class TestPcrModel:
    def test_tandem_repeat_units(self):
        # homopolymer run: position inside AAAA has long repeat length
        bases = b"GGGTAAAAAATGGG"
        rl = prep.find_tandem_repeat_units(bases, 7)
        assert rl >= 5

    def test_pcr_model_caps_gops(self):
        bases = b"ACGTAAAAAAAAAAAAAAAAACGT"
        gops = np.full(len(bases), 45, dtype=np.uint8)
        prep.apply_pcr_error_model(bases, gops, "CONSERVATIVE")
        # inside the homopolymer the gap-open qual must be capped below 45
        assert gops[: len(bases) - 1].min() < 45
        gops2 = np.full(len(bases), 45, dtype=np.uint8)
        prep.apply_pcr_error_model(bases, gops2, "NONE")
        assert np.all(gops2 == 45)

    def test_hostile_caps_harder_than_conservative(self):
        bases = b"ACAGTGTGTGTGTGTGTGCA"
        g_host = np.full(len(bases), 45, dtype=np.uint8)
        g_cons = np.full(len(bases), 45, dtype=np.uint8)
        prep.apply_pcr_error_model(bases, g_host, "HOSTILE")
        prep.apply_pcr_error_model(bases, g_cons, "CONSERVATIVE")
        assert g_host.min() <= g_cons.min()

    def test_native_batch_matches_python(self):
        from rovaca_tpu.native import pcr_native
        rng = np.random.default_rng(7)
        bases_list, want = [], []
        for _ in range(50):
            L = int(rng.integers(5, 160))
            # bias toward repeats: sample from a small alphabet + STR inserts
            b = rng.choice(list(b"ACGT"), size=L).astype(np.uint8)
            if L > 30:
                unit = bytes(rng.choice(list(b"ACGT"),
                                        size=int(rng.integers(1, 5))))
                run = (unit * int(rng.integers(2, 8)))[:L]
                p = int(rng.integers(0, L - len(run) + 1))
                b[p:p + len(run)] = np.frombuffer(run, dtype=np.uint8)
            bases_list.append(bytes(b))
            g = rng.integers(20, 50, size=L).astype(np.uint8)
            want.append(g.copy())
        got = [g.copy() for g in want]
        for b, g in zip(bases_list, want):
            prep.apply_pcr_error_model(b, g, "CONSERVATIVE")
        assert pcr_native.available(), "native pcr lib failed to build"
        prep.apply_pcr_error_model_batch(bases_list, got, "CONSERVATIVE")
        for w, g in zip(want, got):
            np.testing.assert_array_equal(w, g)


class TestCompactBatch:
    """The compact integer layout must reproduce the dense channels exactly
    (the device materializes from the same (128,) tables)."""

    def _random_case(self, seed=3, n_reads=20, n_haps=5):
        rng = np.random.default_rng(seed)

        class _R:
            def __init__(self, bases, quals, mq):
                self.bases = bases
                self.quals = quals
                self.mapping_quality = mq

        reads = []
        for _ in range(n_reads):
            L = int(rng.integers(10, 90))
            reads.append(_R("".join(rng.choice(list("ACGTN"), size=L)),
                            rng.integers(2, 45, size=L),
                            int(rng.integers(10, 61))))
        haps = ["".join(rng.choice(list("ACGT"),
                                   size=int(rng.integers(40, 200))))
                for _ in range(n_haps)]
        return reads, haps

    def test_channels_and_codes_match_dense(self):
        from rovaca_tpu.ops.pairhmm import compact

        reads, haps = self._random_case()
        dense = prep.build_pair_batch(reads, haps)
        comp = compact.build_pair_batch_compact(reads, haps)

        trans = np.asarray(compact.materialize_channels(
            comp.q, comp.gi, comp.gc))
        # padding positions differ by design (dense zeroes channels, compact
        # materializes from q=0) — compare only real (row, lane) entries
        for idx, r in enumerate(reads):
            g, lane = divmod(idx, prep.READ_TILE)
            L = len(r.bases)
            np.testing.assert_array_equal(trans[g, :L, :, lane],
                                          dense.trans[g, :L, :, lane])
            np.testing.assert_array_equal(
                comp.rbase[g, :L, lane].astype(np.int32),
                dense.rbase[g, :L, lane])
        np.testing.assert_array_equal(comp.rlen, dense.rlen)
        np.testing.assert_array_equal(comp.hlen, dense.hlen)
        hbase = np.asarray(compact.broadcast_haps(comp.hcode))
        np.testing.assert_array_equal(hbase, dense.hbase)


class TestQualMods:
    def test_quals_capped_by_mq_and_floored(self):
        q = prep.modify_read_quals([40, 17, 5, 30], mapping_quality=35)
        np.testing.assert_array_equal(q, [35, 6, 6, 30])


class TestSchedulerPacking:
    """Launch packing must respect the canonical shape envelope."""

    def _mk_jobs(self, shapes):
        import dataclasses
        from rovaca_tpu.pipeline.scheduler import PairHMMScheduler, RegionJob

        @dataclasses.dataclass
        class FakeBatch:
            gr: int
            gh: int
            max_read_len: int = 128
            max_hap_len: int = 256

        s = PairHMMScheduler()
        for i, (gr, gh) in enumerate(shapes):
            j = RegionJob(key=i, reads=[], haps=[], pcr_model="NONE")
            j.batch = FakeBatch(gr=gr, gh=gh)
            s.jobs.append(j)
        return s

    def test_pack_respects_envelope(self):
        from rovaca_tpu.pipeline.scheduler import PairHMMScheduler
        s = self._mk_jobs([(3, 2)] * 100)  # 100 jobs, 6 pairs each
        launches = s._pack_launches()
        for (lr, lh), jobs in launches:
            rt = sum(j.batch.gr for j in jobs)
            ht = sum(j.batch.gh for j in jobs)
            pr = sum(j.batch.gr * j.batch.gh for j in jobs)
            assert rt <= PairHMMScheduler.NR_MAX
            assert ht <= PairHMMScheduler.NH_MAX
            assert pr <= PairHMMScheduler.G_MAX
        # every job lands in exactly one launch
        seen = [j.key for _, jobs in launches for j in jobs]
        assert sorted(seen) == list(range(100))

    def test_ladder_is_closed_set(self):
        from rovaca_tpu.pipeline.scheduler import PairHMMScheduler as S
        for n in range(1, S.NR_MAX + 1):
            assert S._ladder(n, S.NR_LADDER) in S.NR_LADDER
        for n in range(1, S.G_MAX + 1):
            assert S._ladder(n, S.G_LADDER) in S.G_LADDER


class TestNativeEngine:
    """Host-native C++ engine (native/pairhmm_cpu.cpp) vs XLA and golden."""

    def _skip_unless_built(self):
        from rovaca_tpu.native import pairhmm_native
        if not pairhmm_native.available():
            pytest.skip("native pairhmm engine did not build")
        return pairhmm_native

    def test_matches_xla_padding_and_lengths(self, rng):
        nat = self._skip_unless_built()
        hap_lens = [17, 31, 60, 44, 25, 50, 38, 29, 61]
        haps = ["".join(rng.choice(list("ACGT"), size=L)) for L in hap_lens]
        reads = [random_read(rng, L) for L in (8, 15, 22, 37, 40, 11)]
        batch = prep.build_pair_batch(reads, haps)
        a = nat.pairhmm_dense(batch.trans, batch.rbase, batch.rlen,
                              batch.hbase, batch.hlen)
        b = np.asarray(pairhmm_xla(batch.trans, batch.rbase, batch.rlen,
                                   batch.hbase, batch.hlen))
        np.testing.assert_allclose(batch.result_matrix(a),
                                   batch.result_matrix(b), rtol=2e-5)

    def test_matches_golden_multi_tile(self, rng):
        nat = self._skip_unless_built()
        reads, haps = make_case(rng, n_reads=150, n_haps=11, read_len=40,
                                hap_len=70)
        batch = prep.build_pair_batch(reads, haps)
        assert batch.gr == 2 and batch.gh == 2   # exercises tile indexing
        raw = nat.pairhmm_dense(batch.trans, batch.rbase, batch.rlen,
                                batch.hbase, batch.hlen)
        got = batch.result_matrix(raw)
        want = golden_matrix(reads, haps, np.float32)
        np.testing.assert_allclose(got, want, rtol=2e-4)

    def test_scheduler_native_dispatch(self, rng):
        self._skip_unless_built()
        from rovaca_tpu.pipeline.scheduler import PairHMMScheduler
        reads, haps = make_case(rng, n_reads=6, n_haps=3)
        sn = PairHMMScheduler(engine="native")
        sn.submit("k", reads, haps)
        lik_n, kept_n = sn.run()["k"]
        sx = PairHMMScheduler(engine="xla")
        sx.submit("k", reads, haps)
        lik_x, kept_x = sx.run()["k"]
        np.testing.assert_array_equal(kept_n, kept_x)
        np.testing.assert_allclose(lik_n, lik_x, rtol=1e-6, atol=1e-9)
