"""Hopper PairHMM kernel (pairhmm_cuda.cu), called through ``jax.ffi``.

Takes the scheduler's compact indexed launch, the same ABI as
compact.pairhmm_indexed_compact, and materializes the probability channels
inside the kernel from the uint8 phreds by table lookup. The library is
built with nvcc at first use (native/build.py). CUDA has no interpret mode:
the CPU tests check this wrapper's inputs against the XLA launch, and the
kernel itself runs only on the card (tests marked ``gpu``).
"""

import ctypes
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from ... import constants as C
from ...native import build
from . import compact

_TARGET = "rovaca_pairhmm_indexed"
_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "pairhmm_cuda.cu")

# read rows per lane, by read-length bucket: one warp (32 lanes) covers a
# whole bucket, except 192 where 5 rows cover 160-bp reads (2x150 and 2x151
# sequencing) with every lane busy; longer reads run in 32*R-row stripes
_ROWS_PER_LANE = {64: 2, 128: 4, 192: 5, 256: 8, 384: 12, 512: 16}


def rows_per_lane(read_len_bucket):
    return _ROWS_PER_LANE.get(read_len_bucket, 16)


def library():
    """Path of the kernel's library, built with nvcc on first use."""
    return build.cuda_lib(_SRC)


@functools.cache
def _register():
    lib = ctypes.CDLL(library())
    jax.ffi.register_ffi_target(
        _TARGET, jax.ffi.pycapsule(lib.RovacaPairhmmIndexed),
        platform="CUDA")


def kernel_inputs(q, gi, gc, rbase8, rlen, hcode8, hlen, hidx, ridx):
    """Positional FFI operands: the launch arrays in the kernel's dtypes
    plus the two (128,) probability tables."""
    ph2pr, m2m = compact._tables()
    return (jnp.asarray(q, jnp.uint8), jnp.asarray(gi, jnp.uint8),
            jnp.asarray(gc, jnp.uint8), jnp.asarray(rbase8, jnp.int8),
            jnp.asarray(rlen, jnp.int32), jnp.asarray(hcode8, jnp.int8),
            jnp.asarray(hlen, jnp.int32), jnp.asarray(hidx, jnp.int32),
            jnp.asarray(ridx, jnp.int32), jnp.asarray(ph2pr),
            jnp.asarray(m2m))


@jax.jit
def pairhmm_cuda_indexed(q, gi, gc, rbase8, rlen, hcode8, hlen, hidx, ridx):
    """Score G tile pairs on the card: (G, 8, 128) f32 raw probabilities,
    output[g] = hap tile hidx[g] against read tile ridx[g]."""
    _register()
    operands = kernel_inputs(q, gi, gc, rbase8, rlen, hcode8, hlen, hidx,
                             ridx)
    out = jax.ShapeDtypeStruct((hidx.shape[0], 8, 128), jnp.float32)
    return jax.ffi.ffi_call(_TARGET, out)(
        *operands, rows_per_lane=np.int32(rows_per_lane(q.shape[1])),
        init_const=np.float32(C.INITIAL_CONSTANT_F32))
