"""Sharding: interval math, merge, mesh step (virtual devices)."""

import os
import sys

import numpy as np

from rovaca_tpu.parallel.sharded_runner import merge_shard_vcfs
from rovaca_tpu.parallel.sharding import make_data_mesh, shard_intervals


class TestShardIntervals:
    def test_balanced_split(self):
        shards = shard_intervals([("chr1", 0, 1000)], 4, boundary_pad=50)
        assert len(shards) == 4
        cores = [(s[0][3], s[0][4]) for s in shards]
        assert cores[0] == (0, 250)
        assert cores[-1][1] == 1000
        # contiguous cores
        for a, b in zip(cores, cores[1:]):
            assert a[1] == b[0]
        # padding present on interior boundaries
        assert shards[1][0][1] == 250 - 50

    def test_multi_contig(self):
        shards = shard_intervals([("chr1", 0, 600), ("chr2", 0, 600)], 3)
        total = sum(c[4] - c[3] for s in shards for c in s)
        assert total == 1200

    def test_more_shards_than_bases(self):
        shards = shard_intervals([("c", 0, 3)], 8)
        total = sum(c[4] - c[3] for s in shards for c in s)
        assert total == 3


class TestMerge:
    def test_merge_headers_once(self, tmp_path):
        f1 = tmp_path / "a.vcf"
        f2 = tmp_path / "b.vcf"
        f1.write_text("##h\n#CHROM\nchr1\t5\tx\n")
        f2.write_text("##h\n#CHROM\nchr1\t10\ty\n")
        out = tmp_path / "m.vcf"
        counts = merge_shard_vcfs([str(f1), str(f2)], str(out))
        lines = out.read_text().splitlines()
        assert counts == [1, 1]
        assert lines.count("##h") == 1
        assert lines[-2:] == ["chr1\t5\tx", "chr1\t10\ty"]


class TestMesh:
    def test_mesh_over_virtual_devices(self):
        import jax
        mesh = make_data_mesh()
        assert mesh.devices.size == len(jax.devices())


def _expand_gvcf(path):
    """Per-position semantic view of a GVCF: variant lines exact; ref
    blocks as (GT, GQ-band) per covered position (block boundaries may
    legitimately differ between sharded and unsharded runs)."""
    from rovaca_tpu import constants as C
    bands = list(C.DEFAULT_GVCF_GQ_BANDS)

    def band(gq):
        for i, b in enumerate(bands):
            if gq < b:
                return i
        return len(bands)

    out = {}
    with open(path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            pos = int(f[1])
            if "END=" in f[7]:
                end = int([kv for kv in f[7].split(";")
                           if kv.startswith("END=")][0][4:])
                sf = dict(zip(f[8].split(":"), f[9].split(":")))
                for p in range(pos, end + 1):
                    out[p] = ("blk", sf["GT"], band(int(sf["GQ"])))
            else:
                out[pos] = ("var", line)
    return out


class TestShardedGvcf:
    def test_sharded_gvcf_semantically_equal(self, tmp_path):
        import numpy as np
        import simdata
        from rovaca_tpu import cli
        from rovaca_tpu.io.fasta import write_fasta

        rng = np.random.default_rng(9)
        L = 6000
        ref = simdata.random_ref(rng, L)
        pos = 3000
        hap = ref[:pos] + ("A" if ref[pos] != "A" else "T") + ref[pos + 1:]
        reads = (simdata.simulate_reads(rng, ref, ref, "chr1", 40)
                 + simdata.simulate_reads(rng, ref, hap, "chr1", 40))
        reads.sort(key=lambda r: r.pos)
        bam = str(tmp_path / "s.bam")
        fa = str(tmp_path / "ref.fa")
        simdata.write_test_bam(bam, reads, "chr1", L)
        write_fasta(fa, {"chr1": ref})

        one = str(tmp_path / "one.g.vcf")
        two = str(tmp_path / "two.g.vcf")
        assert cli.main(["HaplotypeCaller", "-i", bam, "-r", fa, "-o", one,
                         "-e", "GVCF", "--log-level", "WARNING"]) == 0
        assert cli.main(["HaplotypeCaller", "-i", bam, "-r", fa, "-o", two,
                         "-e", "GVCF", "--shards", "2",
                         "--log-level", "WARNING"]) == 0
        a, b = _expand_gvcf(one), _expand_gvcf(two)
        assert a.keys() == b.keys()
        mismatch = {p for p in a if a[p] != b[p]}
        assert not mismatch, sorted(mismatch)[:5]


class TestMultiDeviceScheduler:
    def _jobs(self, sched, rng, n_jobs):
        from conftest import FakeRead
        for j in range(n_jobs):
            reads = []
            for _ in range(5):
                L = int(rng.integers(20, 40))
                bases = "".join(rng.choice(list("ACGT"), size=L))
                reads.append(FakeRead(bases, rng.integers(15, 35, size=L)))
            haps = ["".join(rng.choice(list("ACGT"),
                                       size=int(rng.integers(40, 70))))
                    for _ in range(3)]
            sched.submit(("job", j), reads, [h.encode() for h in haps])

    def test_round_robin_matches_single_device(self):
        """8 virtual CPU devices: results identical to 1-device run."""
        import jax
        import numpy as np
        from rovaca_tpu.pipeline.scheduler import PairHMMScheduler

        devices = jax.devices()
        assert len(devices) >= 2

        rng = np.random.default_rng(33)
        multi = PairHMMScheduler(engine="xla", devices=devices)
        self._jobs(multi, rng, 6)
        out_multi = multi.run()

        rng = np.random.default_rng(33)
        single = PairHMMScheduler(engine="xla", devices=devices[:1])
        self._jobs(single, rng, 6)
        out_single = single.run()

        assert out_multi.keys() == out_single.keys()
        for k in out_multi:
            lik_m, kept_m = out_multi[k]
            lik_s, kept_s = out_single[k]
            assert np.array_equal(kept_m, kept_s)
            assert np.array_equal(lik_m, lik_s)


class TestPipelineDryrun:
    def test_full_pipeline_over_mesh(self):
        """regions -> assembly -> sharded PairHMM (shard_map + ordered
        all_gather) -> genotyping -> merged records == unsharded run."""
        from rovaca_tpu.parallel.pipeline_shard import pipeline_dryrun
        n_records = pipeline_dryrun(4, genome_len=6000)
        assert n_records >= 2


class TestBgzfMerge:
    def test_merge_to_bgzf_with_index(self, tmp_path):
        import gzip

        header = "##fileformat=VCFv4.2\n##contig=<ID=chr1,length=1000>\n" \
                 "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
        a = tmp_path / "a.vcf"
        b = tmp_path / "b.vcf"
        a.write_text(header + "chr1\t10\t.\tA\tC\t50\t.\tDP=9\n")
        b.write_text(header + "chr1\t500\t.\tG\tT\t60\t.\tDP=7\n")
        out = str(tmp_path / "merged.vcf.gz")
        counts = merge_shard_vcfs([str(a), str(b)], out)
        assert counts == [1, 1]
        # true BGZF output, indexed, bodies in order with one header
        import os
        assert os.path.exists(out + ".tbi")
        lines = gzip.open(out, "rt").read().splitlines()
        body = [ln for ln in lines if not ln.startswith("#")]
        assert [ln.split("\t")[1] for ln in body] == ["10", "500"]
        assert sum(1 for ln in lines if ln.startswith("##fileformat")) == 1
        # and the tabix index resolves queries
        from rovaca_tpu.io import tabix
        idx = tabix.TabixIndex.load(out + ".tbi")
        got = list(tabix.fetch_lines(out, idx, "chr1", 400, 600))
        assert len(got) == 1 and got[0].split("\t")[1] == "500"

    def test_merge_bgzf_inputs(self, tmp_path):
        from rovaca_tpu.io import bgzf
        header = "##fileformat=VCFv4.2\n##contig=<ID=chr1,length=1000>\n" \
                 "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
        a = str(tmp_path / "a.vcf.gz")
        with bgzf.Writer(a) as w:
            w.write((header + "chr1\t10\t.\tA\tC\t50\t.\tDP=9\n").encode())
        out = str(tmp_path / "merged.vcf")
        counts = merge_shard_vcfs([a], out)
        assert counts == [1]
        assert "chr1\t10" in open(out).read()


class TestShardCards:
    """--shards on a GPU host: one card per shard process, at most one live
    process per card, the rest queued."""

    def _script(self, tmp_path):
        # each process logs (start, end, CUDA_VISIBLE_DEVICES) to its own file
        return [sys.executable, "-c",
                "import os, sys, time\n"
                "t0 = time.time(); time.sleep(0.3)\n"
                "open(sys.argv[1], 'w').write('%r %r %s' % (t0, time.time(),"
                " os.environ.get('CUDA_VISIBLE_DEVICES', '-')))"]

    def _spans(self, tmp_path, n):
        out = []
        for k in range(n):
            t0, t1, card = (tmp_path / f"p{k}").read_text().split()
            out.append((float(t0), float(t1), card))
        return out

    def test_one_card_per_process_and_queue(self, tmp_path):
        from rovaca_tpu.parallel.sharded_runner import run_processes
        argvs = [self._script(tmp_path) + [str(tmp_path / f"p{k}")]
                 for k in range(5)]
        run_processes(argvs, dict(os.environ), cards=["0", "1"])
        spans = self._spans(tmp_path, 5)
        assert {c for _, _, c in spans} == {"0", "1"}
        for card in ("0", "1"):
            mine = sorted((a, b) for a, b, c in spans if c == card)
            # a card's processes never overlap in time
            assert all(b <= a2 for (_, b), (a2, _) in zip(mine, mine[1:]))

    def test_cpu_shards_run_together(self, tmp_path):
        from rovaca_tpu.parallel.sharded_runner import run_processes
        argvs = [self._script(tmp_path) + [str(tmp_path / f"p{k}")]
                 for k in range(3)]
        env = {k: v for k, v in os.environ.items()
               if k != "CUDA_VISIBLE_DEVICES"}
        run_processes(argvs, env)
        spans = self._spans(tmp_path, 3)
        assert all(c == "-" for _, _, c in spans)
        assert max(a for a, _, _ in spans) < min(b for _, b, _ in spans)

    def test_failed_shard_raises(self, tmp_path):
        import pytest
        from rovaca_tpu.parallel.sharded_runner import run_processes
        with pytest.raises(RuntimeError, match="shard process failed"):
            run_processes([[sys.executable, "-c", "raise SystemExit(3)"]],
                          dict(os.environ), cards=["0"])

    def test_visible_cards_from_env(self, monkeypatch):
        from rovaca_tpu.parallel import sharded_runner
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2, 3")
        assert sharded_runner.visible_cards() == ["2", "3"]
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
        assert sharded_runner.visible_cards() == []

    def test_unpinned_shards_need_a_gpu(self, monkeypatch, tmp_path):
        import pytest
        from rovaca_tpu.io.fasta import write_fasta
        from rovaca_tpu.ops.pairhmm.api import NoDeviceError
        from rovaca_tpu.parallel import sharded_runner
        fa = str(tmp_path / "ref.fa")
        write_fasta(fa, {"chr1": "ACGT" * 100})
        monkeypatch.delenv("JAX_PLATFORMS", raising=False)
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
        with pytest.raises(NoDeviceError):
            sharded_runner.run_sharded(["-r", fa], 2, str(tmp_path / "o"))
