"""Foundations: cell configuration, Gold sequences, CRC, bit manipulation.

Batched counterpart of the reference's lib/src/phy/common and
lib/src/phy/utils layers (lib/src/phy/common/phy_common.c,
lib/src/phy/common/sequence.c, lib/src/phy/fec/crc.c,
lib/src/phy/utils/bit.c) — re-designed as precomputed numpy tables plus
vectorized jnp transforms, not a port of the C implementations.
"""

from .cell import CP, Cell, SF_RE_LEN, sf_sample_len, symbol_sz
from .sequence import gold_sequence, gold_state
from .crc import Crc, CRC24A, CRC24B, CRC16, CRC8
from . import bits

__all__ = [
    "CP",
    "Cell",
    "SF_RE_LEN",
    "sf_sample_len",
    "symbol_sz",
    "gold_sequence",
    "gold_state",
    "Crc",
    "CRC24A",
    "CRC24B",
    "CRC16",
    "CRC8",
    "bits",
]


def device_complex(x):
    """Host complex array -> device complex64 via two float32 transfers.

    Transferring re/im separately and recombining with lax.complex on
    device keeps every host-to-device transfer real-valued.
    """
    import numpy as np

    import jax
    import jax.numpy as jnp

    if isinstance(x, jax.Array):
        return x            # already on device; avoid a host round-trip
    x = np.asarray(x)
    if not np.iscomplexobj(x):
        return jnp.asarray(x)
    re = jnp.asarray(np.ascontiguousarray(x.real, dtype=np.float32))
    im = jnp.asarray(np.ascontiguousarray(x.imag, dtype=np.float32))
    return jax.lax.complex(re, im)
