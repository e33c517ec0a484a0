"""Cross-region PairHMM batching runtime.

The reference keeps one shared thread pool fed with per-region jobs
(reference: src/haplotypecaller/haplotypecaller_engine.cpp:119-146). Here
regions in a window are *prepared* on host (assembly, trimming), their
(read, hap) tile batches bucketed by padded shape, and all regions sharing
a bucket are scored in ONE indexed-kernel launch — amortizing dispatch
latency and filling the card.
"""

import dataclasses

import numpy as np

from .. import constants as C
from ..ops.pairhmm import prep
from ..ops.pairhmm.api import choose_engine, log10_with_rescue, \
    normalize_likelihoods, poorly_modelled_mask


@dataclasses.dataclass
class RegionJob:
    key: object
    reads: list
    haps: list             # bytes
    pcr_model: str
    batch: object = None   # PairBatch or CompactPairBatch
    result: object = None  # (lik[h][r_kept], kept_indices)


class PairHMMScheduler:
    """Collect region scoring jobs; flush in bucketed mega-batches.

    With more than one local device, launches are dispatched round-robin
    across devices — independent region groups are the natural
    data-parallel unit, no collectives needed.

    `counters` (a dict, e.g. the caller's run stats) receives
    pairhmm_device_launches / pairhmm_device_pairs for work launched
    through JAX and pairhmm_native_calls for host-engine calls."""

    def __init__(self, engine="auto", min_quality_threshold=None,
                 devices=None, counters=None):
        self.engine = engine
        self.mqt = (C.MIN_QUALITY_THRESHOLD if min_quality_threshold is None
                    else min_quality_threshold)
        self.jobs = []
        self._devices_override = devices
        self.counters = {} if counters is None else counters

    def _devices(self):
        if self._devices_override is not None:
            return list(self._devices_override)
        import jax
        return jax.local_devices()

    def _count(self, key, n):
        self.counters[key] = self.counters.get(key, 0) + n

    def submit(self, key, reads, hap_seqs, pcr_model="CONSERVATIVE"):
        job = RegionJob(key=key, reads=reads, haps=list(hap_seqs),
                       pcr_model=pcr_model)
        self.jobs.append(job)
        return job

    # ------------------------------------------------------------------
    def run(self):
        """Score all submitted jobs; returns {key: (lik, kept)}."""
        self.dispatch()
        return self.collect()

    # device-launch shape discipline: every jit shape comes from this small
    # closed set, so a cold run compiles a handful of launches (cacheable via
    # the persistent compile cache) instead of one per flush-group size
    NR_MAX = 128      # read tiles per launch (128 x 128 reads)
    NH_MAX = 128      # hap tiles per launch (128 x 8 haps)
    G_MAX = 1024      # (hap-tile, read-tile) pairs per launch
    NR_LADDER = (8, 32, 128)
    NH_LADDER = (8, 32, 128)
    G_LADDER = (64, 256, 1024)

    def dispatch(self):
        """Build batches and enqueue all scoring work WITHOUT fetching.

        Pair with collect(): the caller can do host work (genotyping the
        previous window) while the device sweeps this one — the analogue
        of the reference's producer/consumer thread overlap
        (haplotypecaller.cpp:117-146)."""
        engine = choose_engine(self.engine)
        if engine == "cuda":
            from ..ops.pairhmm import compact
            from ..ops.pairhmm.cuda import pairhmm_cuda_indexed
            for job in self.jobs:
                job.batch = compact.build_pair_batch_compact(
                    job.reads, job.haps, pcr_model=job.pcr_model,
                    min_quality_threshold=self.mqt)
            self._collect_fn = self._dispatch_indexed(pairhmm_cuda_indexed)
            return
        for job in self.jobs:
            job.batch = prep.build_pair_batch(
                job.reads, job.haps, pcr_model=job.pcr_model,
                min_quality_threshold=self.mqt)
        if engine == "native":
            from ..native import pairhmm_native
            if not pairhmm_native.available():
                raise RuntimeError("native pairhmm engine unavailable "
                                   "(g++ build failed?)")
            self._collect_fn = self._dispatch_native()
        else:
            self._collect_fn = self._dispatch_single()

    def collect(self):
        """Fetch + postprocess everything dispatched; {key: (lik, kept)}."""
        if self.jobs and getattr(self, "_collect_fn", None) is not None:
            self._collect_fn()
            self._collect_fn = None
        out = {}
        for job in self.jobs:
            out[job.key] = job.result
        self.jobs = []
        return out

    def _postprocess(self, job, raw_matrix):
        lik_hr = log10_with_rescue(raw_matrix, job.reads, job.haps,
                                   pcr_model=job.pcr_model,
                                   min_quality_threshold=self.mqt)
        lik_rh = normalize_likelihoods(lik_hr.T)
        drop = poorly_modelled_mask([len(r.bases) for r in job.reads],
                                    lik_rh)
        kept = np.nonzero(~drop)[0]
        job.result = (lik_rh[kept].T.copy(), kept)

    def _dispatch_native(self):
        """Score every job's dense batch with the host-native engine.

        Scoring runs on a background thread started at dispatch time, so the
        caller's dispatch()/collect() split buys the same producer/consumer
        overlap the device paths get (the OMP pool parks passively between
        jobs; genotyping of the previous window rides the other core)."""
        import threading

        from ..native import pairhmm_native

        jobs = list(self.jobs)
        raws = [None] * len(jobs)
        error = []
        self._count("pairhmm_native_calls", len(jobs))

        def score():
            try:
                for k, job in enumerate(jobs):
                    b = job.batch
                    raws[k] = pairhmm_native.pairhmm_dense(
                        b.trans, b.rbase, b.rlen, b.hbase, b.hlen)
            except BaseException as e:  # re-raised in collect()
                error.append(e)
        t = threading.Thread(target=score, name="pairhmm-native",
                             daemon=True)
        t.start()

        def collect():
            t.join()
            if error:
                raise error[0]
            for k, job in enumerate(jobs):
                self._postprocess(job, job.batch.result_matrix(raws[k]))
        return collect

    def _dispatch_single(self):
        """Per-job XLA scan launches on the dense layout, dispatched
        round-robin across local devices, all enqueued before the first
        fetch."""
        import jax

        from ..ops.pairhmm.xla import pairhmm_xla

        devices = self._devices()
        pending = []
        for i, job in enumerate(self.jobs):
            b = job.batch
            dev = devices[i % len(devices)]
            args = tuple(jax.device_put(a, dev) for a in
                         (b.trans, b.rbase, b.rlen, b.hbase, b.hlen))
            pending.append((job, pairhmm_xla(*args)))
            self._count("pairhmm_device_launches", 1)
            self._count("pairhmm_device_pairs", len(job.reads) * len(job.haps))

        def collect():
            for job, out in pending:
                self._postprocess(job,
                                  job.batch.result_matrix(np.asarray(out)))
        return collect

    @classmethod
    def _ladder(cls, n, ladder):
        for v in ladder:
            if v >= n:
                return v
        return ladder[-1]

    def _pack_launches(self):
        """Greedy-pack jobs of a (Lr, Lh) bucket into launches bounded by
        (NR_MAX, NH_MAX, G_MAX); each launch pads its tile stacks and pair
        count UP the fixed ladders, so every jit shape belongs to the small
        closed set {Lr} x {Lh} x NR_LADDER x NH_LADDER x G_LADDER."""
        groups = {}
        for job in self.jobs:
            b = job.batch
            groups.setdefault((b.max_read_len, b.max_hap_len),
                              []).append(job)
        launches = []
        for (lr, lh), jobs in groups.items():
            cur, rt, ht, pr = [], 0, 0, 0
            for job in jobs:
                b = job.batch
                jp = b.gh * b.gr
                assert (b.gr <= self.NR_MAX and b.gh <= self.NH_MAX
                        and jp <= self.G_MAX), \
                    (b.gr, b.gh, jp, "region exceeds launch envelope")
                if cur and (rt + b.gr > self.NR_MAX
                            or ht + b.gh > self.NH_MAX
                            or pr + jp > self.G_MAX):
                    launches.append(((lr, lh), cur))
                    cur, rt, ht, pr = [], 0, 0, 0
                cur.append(job)
                rt += b.gr
                ht += b.gh
                pr += jp
            if cur:
                launches.append(((lr, lh), cur))
        return launches

    def build_launches(self):
        """Pack the compact job batches into indexed launches.

        Returns [(jobs, spans, args)]: `args` are the numpy launch arrays
        (q, gi, gc, rbase, rlen, hcode, hlen, hidx, ridx) in the compact
        indexed ABI (ops/pairhmm/compact.py), and `spans[k]` is the slice of
        launch pairs holding jobs[k]'s (gh, gr) tile block in row-major
        order. Pair slots past the real pairs index tile -1: they score
        nothing (the XLA scan reads some tile and its rows are ignored)."""
        launches = []
        for (lr, lh), jobs in self._pack_launches():
            q_t, gi_t, gc_t, rbase, rlen, hcode, hlen = ([] for _ in range(7))
            hidx, ridx, spans = [], [], []
            for job in jobs:
                b = job.batch
                r_off = len(rlen)
                h_off = len(hlen)
                for g in range(b.gr):
                    q_t.append(b.q[g])
                    gi_t.append(b.gi[g])
                    gc_t.append(b.gc[g])
                    rbase.append(b.rbase[g])
                    rlen.append(b.rlen[g])
                for g in range(b.gh):
                    hcode.append(b.hcode[g])
                    hlen.append(b.hlen[g])
                k0 = len(hidx)
                for hh in range(b.gh):
                    for rr in range(b.gr):
                        hidx.append(h_off + hh)
                        ridx.append(r_off + rr)
                spans.append(slice(k0, len(hidx)))

            g_pad = self._ladder(len(hidx), self.G_LADDER)
            nr_pad = self._ladder(len(rlen), self.NR_LADDER)
            nh_pad = self._ladder(len(hlen), self.NH_LADDER)

            def stack_to(tiles, n_pad):
                # padding tiles are never indexed; they only ride the
                # transfer
                out = np.zeros((n_pad,) + tiles[0].shape, tiles[0].dtype)
                out[:len(tiles)] = np.stack(tiles)
                return out

            def index_to(idx):
                out = np.full(g_pad, -1, dtype=np.int32)
                out[:len(idx)] = idx
                return out

            args = (stack_to(q_t, nr_pad), stack_to(gi_t, nr_pad),
                    stack_to(gc_t, nr_pad), stack_to(rbase, nr_pad),
                    stack_to(rlen, nr_pad), stack_to(hcode, nh_pad),
                    stack_to(hlen, nh_pad), index_to(hidx), index_to(ridx))
            launches.append((jobs, spans, args))
        return launches

    def _dispatch_indexed(self, launch_fn):
        """Score the compact job batches with `launch_fn` (the compact
        indexed ABI), one call per packed launch."""
        import jax

        # dispatch every launch before fetching any result: device work and
        # transfer latency overlap across launches (and across cards —
        # launches round-robin over local devices)
        devices = self._devices()
        pending = []
        for k, (jobs, spans, args) in enumerate(self.build_launches()):
            dev = devices[k % len(devices)]
            args = tuple(jax.device_put(a, dev) for a in args)
            pending.append((jobs, spans, launch_fn(*args)))
            self._count("pairhmm_device_launches", 1)
            self._count("pairhmm_device_pairs",
                        sum(len(j.reads) * len(j.haps) for j in jobs))

        def collect():
            for jobs, spans, device_out in pending:
                raw = np.asarray(device_out)
                for job, span in zip(jobs, spans):
                    b = job.batch
                    full = raw[span].reshape(b.gh, b.gr, 8, 128)
                    self._postprocess(job, b.result_matrix(full))
        return collect
