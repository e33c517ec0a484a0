"""rovaca_tpu — a germline variant-calling engine in JAX.

A from-scratch reimplementation of the capabilities of Rovaca (a GATK4
HaplotypeCaller-equivalent germline SNP/INDEL caller):

- The dominant compute kernel — the PairHMM forward algorithm scoring every
  (read, haplotype) pair — runs on an NVIDIA GPU as a CUDA kernel called
  through jax.ffi, over launches that pack many regions' (8 haplotypes x
  128 reads) tiles (``rovaca_tpu.ops.pairhmm``).
- Irregular host work (BAM/FASTA/BED/VCF IO, activity profiling,
  read-threading assembly, Smith-Waterman realignment, genotyping
  bookkeeping, VCF writing) runs on host, in numpy and native C++.
- Multi-device / multi-host scale-out is interval-sharded data parallelism:
  launches round-robin over local cards, one shard process per card, or a
  ``jax.sharding.Mesh`` with a coordinate-ordered gather for output merge
  (``rovaca_tpu.parallel``).

Reference behavior is documented against ZephyRoy/Rovaca (cited as
``reference:<path>:<line>`` in docstrings); the implementation here is new,
not a translation. The package name is historical.
"""

__version__ = "0.1.0"
