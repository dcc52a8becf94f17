"""Join-key normalization (port of radixjoin_tpu/ops/keynorm.py).

The reference compares keys as typed C++ values (src/execute.cpp:215,
:231): doubles match by value (-0.0 == +0.0, NaN never equal) and strings
by content. On the device keys are compared as i64 bit patterns and
dictionary ids, so the engine applies two normalizations:

- :func:`canon_f64_bits`: FP64 keys as bitcast int64 (tensors, or numpy
  arrays on the host-staged spill path) with -0.0
  canonicalized to +0.0 and NaN keys invalidated;
- :func:`joint_id_inverse`: two string dictionaries mapped onto one joint
  id space (exact ``np.unique`` merge) so id equality == byte equality.
"""

import numpy as np
import torch

F64_SIGN = -(2 ** 63)  # 0x8000000000000000 == -0.0
F64_EXP = 0x7FF0000000000000
F64_MANT = 0x000FFFFFFFFFFFFF


def canon_f64_bits(bits, valid):
    """FP64 join-key canonicalization on int64 bit patterns: ``-0.0`` bits
    become ``+0.0`` bits so they compare equal, and NaN rows are dropped
    from ``valid`` so NaN never matches. Returns ``(canon_bits, valid)``.

    Takes tensors (the device paths) or numpy arrays (the spill path's
    host-side keys), and answers in kind, bit for bit the same."""
    is_nan = ((bits & F64_EXP) == F64_EXP) & ((bits & F64_MANT) != 0)
    if isinstance(bits, np.ndarray):
        canon = np.where(bits == F64_SIGN, np.int64(0), bits)
    else:
        canon = torch.where(bits == F64_SIGN, torch.zeros_like(bits), bits)
    return canon, valid & ~is_nan


def joint_id_inverse(oa: np.ndarray, ob: np.ndarray):
    """Map two dictionaries' object arrays onto one joint id space.

    Returns ``(ra, rb, size)``: i32 lookup tables (old id -> joint id)
    for each side and the joint dictionary size. Equal byte strings get
    equal joint ids; everything else distinct ids.
    """
    if not (len(oa) or len(ob)):
        return np.zeros(0, np.int32), np.zeros(0, np.int32), 0
    uniq, inverse = np.unique(np.concatenate([oa, ob]), return_inverse=True)
    inverse = inverse.astype(np.int32)
    return inverse[: len(oa)], inverse[len(oa):], len(uniq)
