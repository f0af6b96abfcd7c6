"""Turbo-code BLER vs Eb/N0 sweep (the BLER-parity measurement hook).

Produces the waterfall curve for a CB size; the reference's equivalent
operating point is turbodecoder_test at -e <snr> (its CTest registrations
sweep sizes and SNRs). Runs on the GPU (JAX_PLATFORMS=cpu for the CPU):

  python tools/bler_sweep.py [k] [batch_per_point] [int8]

Pass "int8" as the third argument to run the quantized LLR lane
(demod byte scale 8 per LLR unit, ±127 saturation — the
tests/test_int8_lane.py transport path) for waterfall parity vs f32.
"""

import sys

import _pathfix  # noqa: F401  (repo root on sys.path)

import numpy as np

import jax
import jax.numpy as jnp

from empower_srslte_tpu.ops.fec import TurboDecoder, turbo_encode_np


def main():
    k = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    batch = int(sys.argv[2]) if len(sys.argv) > 2 else 64
    int8 = len(sys.argv) > 3 and sys.argv[3] == "int8"

    rng = np.random.default_rng(0)
    dec = TurboDecoder(k=k, iterations=6, window=(128 if k % 128 == 0 else 64))
    fn = jax.jit(dec.decode)

    print(f"# K={k}, rate 1/3, max-log-MAP 6 iter, window decode, "
          f"{batch} CB/point, llr={'int8' if int8 else 'f32'}")
    print("# EbN0_dB  BLER      BER")
    for ebn0_db in (0.0, 0.4, 0.8, 1.0, 1.2, 1.6, 2.0):
        u = rng.integers(0, 2, size=(batch, k)).astype(np.int8)
        d = turbo_encode_np(u)
        ebn0 = 10 ** (ebn0_db / 10)
        n0 = 1.0 / (ebn0 / 3)
        y = (1 - 2 * d.astype(np.float64)
             + np.sqrt(n0 / 2) * rng.normal(size=d.shape))
        llr_f = (4 / n0 * y).astype(np.float32)
        if int8:
            llr_f = np.clip(np.round(llr_f * 8.0), -127, 127)
        llr = jnp.asarray(llr_f.astype(np.int8) if int8
                          else llr_f)
        bits, _ = fn(llr)
        errs = np.asarray(bits) != u
        bler = float(np.mean(errs.any(axis=1)))
        ber = float(np.mean(errs))
        print(f"{ebn0_db:8.1f}  {bler:8.4f}  {ber:.2e}")


if __name__ == "__main__":
    main()
