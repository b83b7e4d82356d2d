"""Secret zeroization of host buffers (she_tpu/utils/zeroize.py:19;
reference Zeroization.swift:1-40).

Overwrites a bytearray or a writable C-contiguous numpy array in place with
ctypes.memset. A torch tensor is scrubbed with its own zero_(), on the
host or on the card (bfv.SecretKey.zeroize).
"""

from __future__ import annotations

import ctypes

import numpy as np


def zeroize(buf) -> None:
    """Overwrite a mutable host buffer with zeros."""
    if isinstance(buf, bytearray):
        if not buf:
            return
        addr = ctypes.addressof((ctypes.c_char * len(buf)).from_buffer(buf))
        size = len(buf)
    elif isinstance(buf, np.ndarray):
        if not buf.flags.writeable or not buf.flags.c_contiguous:
            raise ValueError("can only zeroize writable contiguous arrays")
        addr = buf.ctypes.data
        size = buf.nbytes
    else:
        raise TypeError(f"cannot zeroize {type(buf)}")
    ctypes.memset(addr, 0, size)
