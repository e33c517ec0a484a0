"""PairHMM read-vs-haplotype likelihoods.

The reference scores every (read, haplotype) pair with an AVX512 forward
algorithm, 16 reads per vector (reference: src/haplotypecaller/pairhmm/
rovaca/avx_512_float.cc:29-183). Here the same model runs on the card as a
CUDA kernel, one warp per pair, over launches that pack many regions'
(8 haplotypes x 128 reads) tiles.

Layers:
- ``prep``:    host-side batch preparation (qual caps, PCR/STR model,
               transition/emission channel tables, padding + tiling)
- ``compact``: the integer launch layout the scheduler ships to the card
- ``golden``:  scalar numpy forward in float32/float64 (the correctness
               oracle and the double-precision rescue path)
- ``xla``:     pure-XLA lax.scan implementation (the plain reference)
- ``cuda``:    the Hopper kernel through jax.ffi
- ``api``:     engine choice and end-to-end scoring (log10 conversion,
               rescue, normalization, poorly-modelled-read filtering)
"""

from .api import compute_likelihoods  # noqa: F401
from .prep import PairBatch, build_pair_batch, prepare_read_channels  # noqa: F401
