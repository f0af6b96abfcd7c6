"""Headline benchmarks: turbo decoder + full receivers, one JSON line.

Primary metric mirrors the reference's turbodecoder_test measurement
(lib/src/phy/fec/test/turbodecoder_test.c:281 prints Mbps per CB size and
iteration count; README.md:25 claims >100 Mbps with SSE4.1/AVX2) at the
same operating point: K=6144, Eb/N0=1.5 dB, 5 iterations, correctness
checked (zero residual bit errors expected at this SNR).

Additional keys carry the full-receiver numbers the reference publishes
(README.md:39-41,58: 150 Mbps 20 MHz MIMO DL, 36 Mbps 10 MHz SISO DL,
50 Mbps 20 MHz UL), measured like pdsch_test.c:446-517 decode-processing
Mbps. Set BENCH_QUICK=1 to skip the receiver benches.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}
with vs_baseline relative to the reference's 100 Mbps SIMD figure, and
the device it ran on (platform, kind, count, and the card's name and
power limit from nvidia-smi). A phase that fails ends the run with a
non-zero exit code.
"""

import json
import os
import subprocess
import time

import numpy as np

import jax
import jax.numpy as jnp

from empower_srslte_tpu.backend import configure_compile_cache

# persistent compile cache: the turbo + receiver programs take minutes to
# compile cold; cached re-runs leave the time budget to the measurements
configure_compile_cache()

BASELINE_MBPS = 100.0  # reference AVX2 turbo decode (README.md:25)
RX_BASELINE = {"20mimo": 150.0, "10siso": 36.0, "20ul": 50.0}


def _sync(x):
    """Wait for the device and return the (scalar) result as an int."""
    return int(jax.block_until_ready(x))


def require(ok: bool, what: str, r=None) -> None:
    """End the run with a non-zero exit code when a phase's check fails,
    before its numbers are printed as a result."""
    if not ok:
        raise SystemExit(f"bench: {what} failed: {json.dumps(r)}")


def bad_bits(bits, tb, ok):
    """Wrong decoded bits over the TBs whose CRC passed: 0 means no
    CRC-passing TB differs from the sent one. It consumes the decoded
    PAYLOAD fully (not just the CRC flags): dead decoded bits let XLA
    drop the reassembly stage."""
    return jnp.sum(((bits != tb) & ok[..., None]).astype(jnp.int32))


def memory_summary(compiled) -> dict:
    """Device memory of a compiled program (compiled.memory_analysis())."""
    m = compiled.memory_analysis()
    if m is None:
        return {}
    return {k: int(getattr(m, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")
        if hasattr(m, k)}


def card_info() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip() or out.stderr.strip()


def bench_turbo():
    from empower_srslte_tpu.ops.fec import TurboDecoder, turbo_encode_np

    k = 6144
    batch = 2048
    iters = 5

    rng = np.random.default_rng(0)
    tile = 8  # host-encode a fraction and tile it: same decode workload
    u0 = rng.integers(0, 2, size=(batch // tile, k)).astype(np.int8)
    u = np.tile(u0, (tile, 1))
    d = np.tile(turbo_encode_np(u0), (tile, 1, 1))
    ebn0 = 10 ** (1.5 / 10)
    n0 = 1.0 / (ebn0 / 3)
    sigma = np.sqrt(n0 / 2)
    y = 1 - 2 * d.astype(np.float64) + sigma * rng.normal(size=d.shape)
    llr = jnp.asarray((4 / n0 * y).astype(np.float32))

    # bfloat16 metrics on the kernel path (dtype="auto") — the same
    # precision trade the reference's i16/i8 SIMD decoders make
    # (demod_soft.c:39-45); impl auto = the NII Pallas kernel
    # (turbo_decoder_pallas2.py) on the GPU, the scan on the CPU.
    dec = TurboDecoder(k=k, iterations=iters, window=256)

    # Chain R decodes per dispatch (scalar cross-decode dependency) so the
    # steady-state streaming throughput is measured rather than the
    # per-dispatch host overhead. The chain rides a lax.scan so XLA
    # compiles ONE decode body.
    chain = 24

    @jax.jit
    def fn(llr):
        # scalar cross-call carry: the dependency is a broadcast add
        # that fuses into the decode's first read (a full-size carry
        # add would cost an extra ~0.45 ms HBM pass per chained call)
        def body(carry, _):
            eps, _ = carry
            bits, llr_out = dec.decode(llr + 0.0 * eps)
            return (llr_out[0, 0].astype(llr.dtype), bits), None

        bits0 = jnp.zeros((batch, k), jnp.int8)
        (_, bits), _ = jax.lax.scan(
            body, (jnp.zeros((), llr.dtype), bits0), None, length=chain)
        return bits

    fn = fn.lower(llr).compile()
    bits = fn(llr)
    errs = int(np.sum(np.asarray(bits) != u))  # also forces full sync

    # several timed trials; report the best
    best = 0.0
    for _ in range(3):
        n_rep = 2
        t0 = time.time()
        for _ in range(n_rep):
            bits = fn(llr)
        jax.block_until_ready(bits)
        dt = (time.time() - t0) / (n_rep * chain)
        best = max(best, batch * k / dt / 1e6)
    return round(best, 1), errs, batch


#: Mid-SNR noise levels (waterfall edge, where the CRC early stop
#: actually iterates): chosen so BLER lands in the 1-50 % band — the
#: operating point the reference's phy_dl_test.c:371-408 sweeps report.
#: (20ul recalibrated round 5: 0.046 sat past the waterfall edge at
#: BLER 14.5-17 % — above the ~10 % first-transmission operating target
#: — flattering Mbps; 0.045 measures BLER ~7 %)
MIDSNR_N0 = {"20mimo": 0.009, "10siso": 0.042, "20ul": 0.045}


def bench_receiver(config: str, batch: int = 256, chain: int = 24,
                   midsnr: bool = False):
    """Decode-processing throughput of the full receivers
    (BASELINE configs 2/3/4).

    ``chain`` receiver calls ride one dispatch via lax.scan (a scalar
    cross-call dependency prevents CSE), so steady-state on-device
    throughput is measured rather than the per-dispatch host overhead —
    the same treatment the turbo bench documents. ``midsnr`` switches
    the noise level to the waterfall edge and reports (bler, iterations)
    alongside Mbps, so the early-stop depth is captured, not asserted.

    Returns a dict: mbps, sfps, crc_ok (every CRC of every call passed),
    tb_exact (every TB whose CRC passed equals the transmitted one),
    iters, bler.
    """
    from empower_srslte_tpu.models import ra
    from empower_srslte_tpu.models.pdsch import (PdschConfig, pdsch_decode,
                                                 pdsch_encode)
    from empower_srslte_tpu.ops.equalizer import MimoType
    from empower_srslte_tpu.utils import Cell

    rng = np.random.default_rng(0)
    n0 = MIDSNR_N0[config] if midsnr else 1e-3
    sigma = np.sqrt(n0 / 2)
    if config == "20mimo":
        cell = Cell(nof_prb=100, nof_ports=2, id=1)
        mod, tbs = ra.mcs_to_tbs(27, 100)
        cfg = PdschConfig(cell=cell, sf_idx=1, cfi=1, mod=mod,
                          mimo=MimoType.SPATIAL_MUX, nof_layers=2,
                          nof_codewords=2)
        plan = cfg.plan(tbs)
        tb = rng.integers(0, 2, size=(batch, tbs)).astype(np.int8)
        tb2 = rng.integers(0, 2, size=(batch, tbs)).astype(np.int8)
        hs = (batch, 2, 2, 14, 1200)
        ns = (batch, 2, 14, 1200)
        h_re = rng.normal(size=hs).astype(np.float32)
        h_im = rng.normal(size=hs).astype(np.float32)
        nz_re = (rng.normal(size=ns) * sigma).astype(np.float32)
        nz_im = (rng.normal(size=ns) * sigma).astype(np.float32)

        def make_rx(tb, tb2, h_re, h_im, nz_re, nz_im):
            h = jax.lax.complex(h_re, h_im)
            ports = pdsch_encode(tb, cfg, plan, tb2, plan)
            y = (jnp.einsum("brpsk,bpsk->brsk", h, ports)
                 + jax.lax.complex(nz_re, nz_im))
            return jnp.real(y), jnp.imag(y)

        make_rx = jax.jit(make_rx)
        y_re, y_im = make_rx(*(jnp.asarray(a) for a in
                               (tb, tb2, h_re, h_im, nz_re, nz_im)))
        args = (y_re, y_im, jnp.asarray(h_re), jnp.asarray(h_im),
                jnp.asarray(tb), jnp.asarray(tb2))

        def fn(y_re, y_im, h_re, h_im, tb, tb2):
            y = jax.lax.complex(y_re, y_im)
            h = jax.lax.complex(h_re, h_im)
            ilist = []
            (b1, b2), (ok1, ok2), _ = pdsch_decode(
                y, h, cfg, plan, noise_est=n0, plan2=plan, iters_out=ilist)
            n_it = jnp.max(jnp.stack(ilist)) if ilist \
                else jnp.zeros((), jnp.int32)
            n_bad = bad_bits(b1, tb, ok1) + bad_bits(b2, tb2, ok2)
            return (jnp.sum(ok1) + jnp.sum(ok2)).astype(jnp.int32), \
                n_it, n_bad

        bits_per_sf = 2 * tbs
        n_expected = 2 * batch
    elif config == "20ul":
        from empower_srslte_tpu.models.pusch import (PuschConfig,
                                                     pusch_decode,
                                                     pusch_encode)

        cell = Cell(nof_prb=100, nof_ports=1, id=1)
        mod, tbs = ra.mcs_to_tbs(20, 96, dl=False)
        cfg = PuschConfig(cell=cell, sf_idx=1, rnti=0x1234, mod=mod,
                          prb_start=0, n_prb=96)
        plan = cfg.plan(tbs)
        tb = rng.integers(0, 2, size=(batch, tbs)).astype(np.int8)
        ns = (batch, 14, 1200)
        nz_re = (rng.normal(size=ns) * sigma).astype(np.float32)
        nz_im = (rng.normal(size=ns) * sigma).astype(np.float32)

        def make_rx(tb, nz_re, nz_im):
            grid = pusch_encode(tb, cfg, plan)
            hval = jax.lax.complex(jnp.float32(0.95), jnp.float32(0.1))
            y = grid * hval + jax.lax.complex(nz_re, nz_im)
            return jnp.real(y), jnp.imag(y)

        make_rx = jax.jit(make_rx)
        y_re, y_im = make_rx(*(jnp.asarray(a) for a in (tb, nz_re, nz_im)))
        args = (y_re, y_im, jnp.asarray(tb))

        def fn(y_re, y_im, tb):
            y = jax.lax.complex(y_re, y_im)
            ilist = []
            bits, ok, _ = pusch_decode(y, cfg, plan, noise_est=n0,
                                       iters_out=ilist)
            n_it = jnp.max(jnp.stack(ilist)) if ilist \
                else jnp.zeros((), jnp.int32)
            return jnp.sum(ok).astype(jnp.int32), n_it, \
                bad_bits(bits, tb, ok)

        bits_per_sf = tbs
        n_expected = batch
    else:  # 10siso
        cell = Cell(nof_prb=50, nof_ports=1, id=1)
        mod, tbs = ra.mcs_to_tbs(23, 50)
        cfg = PdschConfig(cell=cell, sf_idx=1, cfi=1, mod=mod)
        plan = cfg.plan(tbs)
        tb = rng.integers(0, 2, size=(batch, tbs)).astype(np.int8)
        ns = (batch, 1, 14, 600)   # matches the encoder's port axis
        nz_re = (rng.normal(size=ns) * sigma).astype(np.float32)
        nz_im = (rng.normal(size=ns) * sigma).astype(np.float32)

        def make_rx(tb, nz_re, nz_im):
            grid = pdsch_encode(tb, cfg, plan)
            hval = jax.lax.complex(jnp.float32(0.9), jnp.float32(-0.2))
            y = grid * hval + jax.lax.complex(nz_re, nz_im)
            return jnp.real(y), jnp.imag(y)

        make_rx = jax.jit(make_rx)
        y_re, y_im = make_rx(*(jnp.asarray(a) for a in (tb, nz_re, nz_im)))
        args = (y_re, y_im, jnp.asarray(tb))

        def fn(y_re, y_im, tb):
            y = jax.lax.complex(y_re, y_im)
            hval = jax.lax.complex(jnp.float32(0.9), jnp.float32(-0.2))
            h = jnp.broadcast_to(hval, (batch, 1, 1, 14, 600))
            ilist = []
            bits, ok, _ = pdsch_decode(y, h, cfg, plan, noise_est=n0,
                                       iters_out=ilist)
            n_it = jnp.max(jnp.stack(ilist)) if ilist \
                else jnp.zeros((), jnp.int32)
            return jnp.sum(ok).astype(jnp.int32), n_it, \
                bad_bits(bits, tb, ok)

        bits_per_sf = tbs
        n_expected = batch

    @jax.jit
    def chained(*cargs):
        # scalar cross-call carry (see bench_turbo note); the carry is
        # the decoded-bit error count, so the payload is consumed
        def body(carry, _):
            eps, acc, itm, bad = carry
            a0 = cargs[0] + (0.0 * eps).astype(cargs[0].dtype)
            n_ok, n_it, n_bad = fn(a0, *cargs[1:])
            return (n_bad.astype(jnp.float32), acc + n_ok,
                    jnp.maximum(itm, n_it), bad + n_bad), None
        zi = jnp.zeros((), jnp.int32)
        (_, acc, itm, bad), _ = jax.lax.scan(
            body, (jnp.zeros((), jnp.float32), zi, zi, zi), None,
            length=chain)
        return acc, itm, bad

    chained = chained.lower(*args).compile()
    acc, itm, bad = chained(*args)
    n_ok = _sync(acc)
    n_it = _sync(itm)
    n_bad = _sync(bad)
    best_mbps = best_sfps = 0.0
    for _ in range(3):
        reps = 2
        t0 = time.time()
        r = None
        for _ in range(reps):
            r = chained(*args)
        jax.block_until_ready(r)
        dt = (time.time() - t0) / (reps * chain)
        if batch * bits_per_sf / dt / 1e6 > best_mbps:
            best_mbps = batch * bits_per_sf / dt / 1e6
            best_sfps = batch / dt
    bler = 1.0 - n_ok / float(chain * n_expected)
    return {"mbps": round(best_mbps, 0), "sfps": round(best_sfps, 0),
            "crc_ok": n_ok == chain * n_expected, "tb_exact": n_bad == 0,
            "iters": n_it, "bler": round(bler, 4),
            "memory": memory_summary(chained)}


def bench_uedl(batch: int = 256, chain: int = 24, mimo: bool = False):
    """Full-chain UE DL receiver, NO genie anything: time-domain samples
    -> OFDM FFT -> LS channel estimation off the CRS -> pilot noise
    estimate -> PCFICH decode -> blind PDCCH search (every (L, CCE)
    candidate of the UE search space x both monitored DCI sizes, Viterbi
    + CRC16-RNTI) -> PDSCH decode with the ESTIMATED channel.

    This is the measurement the reference publishes live
    (lib/examples/pdsch_ue.c:786-827); the processing-Mbps receivers
    above start at the RE grid with a genie channel (pdsch_test.c
    parity). Default: 10 MHz SISO MCS 23, AWGN at 30 dB.

    ``mimo``: 20 MHz 2x2 TM4 two-codeword variant — per-subframe random
    full-rank 2x2 channel applied in the frequency domain before the
    per-antenna iFFT, CRS channel estimation per (rx, port) pair, SFBC
    control channels — the configuration behind the reference's 150 Mbps
    full-chain headline (README.md:39 there).
    """
    from empower_srslte_tpu.models import ra
    from empower_srslte_tpu.models.dci import format0_1a_size, format1_size
    from empower_srslte_tpu.models.enb_dl import (enb_dl_base_grid,
                                                  enb_dl_gen_signal)
    from empower_srslte_tpu.models.pcfich import pcfich_decode, pcfich_put
    from empower_srslte_tpu.models.pdcch import (pdcch_blind_bits,
                                                 pdcch_encode,
                                                 pdcch_extract_llr,
                                                 ue_search_candidates)
    from empower_srslte_tpu.models.pdsch import (PdschConfig, pdsch_decode,
                                                 pdsch_encode)
    from empower_srslte_tpu.models.regs import pdcch_nof_cces
    from empower_srslte_tpu.ops.chest import chest_dl, noise_est_pilots
    from empower_srslte_tpu.ops.equalizer import MimoType
    from empower_srslte_tpu.ops.ofdm import ofdm_rx_sf
    from empower_srslte_tpu.utils import Cell
    from empower_srslte_tpu.utils.bits import uint_to_bits
    from empower_srslte_tpu.utils.crc import CRC16

    rng = np.random.default_rng(7)
    sf_idx, cfi, rnti = 1, 1, 0x1234
    if mimo:
        cell = Cell(nof_prb=100, nof_ports=2, id=1)
        mod, tbs = ra.mcs_to_tbs(25, 100)
        cfg = PdschConfig(cell=cell, sf_idx=sf_idx, cfi=cfi, rnti=rnti,
                          mod=mod, mimo=MimoType.SPATIAL_MUX,
                          nof_layers=2, nof_codewords=2)
        n_cw, n_rx = 2, 2
        nprb = 100
    else:
        cell = Cell(nof_prb=50, nof_ports=1, id=1)
        mod, tbs = ra.mcs_to_tbs(23, 50)
        cfg = PdschConfig(cell=cell, sf_idx=sf_idx, cfi=cfi, rnti=rnti,
                          mod=mod)
        n_cw, n_rx = 1, 1
        nprb = 50
    plan = cfg.plan(tbs)
    size1 = format1_size(nprb)
    size1a = format0_1a_size(nprb)
    dci_l, dci_cce = 4, 0
    dci_bits = rng.integers(0, 2, size1).astype(np.int8)

    tb = rng.integers(0, 2, size=(batch, tbs)).astype(np.int8)
    tb2 = rng.integers(0, 2, size=(batch, tbs)).astype(np.int8)
    sf_len = cell.sf_sample_len
    snr_db = 30.0
    # per-subframe well-conditioned 2x2 mixing channel (diag-dominant
    # with random phases): exercises per-(rx, port) chest + 2x2 MMSE
    # without the capture depending on worst-case Rayleigh conditioning
    ph = rng.uniform(0, 2 * np.pi, size=(batch, 2, 2))
    mag = np.where(np.eye(2, dtype=bool)[None], 1.0, 0.35)
    h2 = (mag * np.exp(1j * ph)).astype(np.complex64)

    def make_tx(tb, tb2, h2_re, h2_im, nz_re, nz_im):
        grid = enb_dl_base_grid(cell, sf_idx, batch_shape=(batch,))
        grid = pcfich_put(grid, cfi, cell, sf_idx)
        grid = grid + pdcch_encode(jnp.asarray(dci_bits), rnti, dci_cce,
                                   dci_l, cell, cfi, sf_idx)
        if mimo:
            grid = grid + pdsch_encode(tb, cfg, plan, tb2, plan)
            h2c = jax.lax.complex(h2_re, h2_im)
            grid = jnp.einsum("brp,bpsk->brsk", h2c, grid)
        else:
            grid = grid + pdsch_encode(tb, cfg, plan)
        samples = enb_dl_gen_signal(grid, cell)
        if not mimo:
            samples = samples[..., 0, :]
        p_sig = jnp.mean(jnp.abs(samples) ** 2)
        sigma = jnp.sqrt(p_sig * 10 ** (-snr_db / 10) / 2)
        y = samples + sigma * jax.lax.complex(nz_re, nz_im)
        return jnp.real(y), jnp.imag(y)

    cands = ue_search_candidates(rnti, sf_idx,
                                 pdcch_nof_cces(cell, cfi))
    mask16 = jnp.asarray(uint_to_bits(rnti & 0xFFFF, 16))

    def fn(s_re, s_im, tb, tb2):
        samples = jax.lax.complex(s_re, s_im)
        grid = ofdm_rx_sf(samples, cell)        # [B(, rx), S, K]
        if mimo:
            h = jnp.stack(
                [jnp.stack([chest_dl(grid[:, r], cell, sf_idx, port=p)
                            for p in range(2)], axis=1)
                 for r in range(2)], axis=1)    # [B, rx, port, S, K]
            n0 = jnp.maximum(noise_est_pilots(grid[:, 0], cell, sf_idx),
                             1e-7)
            grid0, h0 = grid[:, 0], h[:, 0]     # rx antenna 0 for control
        else:
            h = chest_dl(grid, cell, sf_idx, port=0)
            n0 = jnp.maximum(noise_est_pilots(grid, cell, sf_idx), 1e-7)
            grid0, h0 = grid, h
        cfi_hat, _ = pcfich_decode(grid0, h0, cell, sf_idx,
                                   noise_est=n0[..., None])
        cfi_ok = jnp.sum((cfi_hat == cfi).astype(jnp.int32))
        # blind DCI search: all candidates x both monitored sizes
        llr = pdcch_extract_llr(grid0, h0, cell, cfi, sf_idx,
                                noise_est=n0[..., None])
        # one Viterbi batch per monitored DCI size, every candidate of
        # every aggregation level stacked (pdcch_blind_bits)
        n_det = jnp.zeros((), jnp.int32)
        for size in {size1, size1a}:
            bits = pdcch_blind_bits(llr, cands, size)  # [B, n_cand, k]
            unmasked = jnp.concatenate(
                [bits[..., :size],
                 jnp.bitwise_xor(bits[..., size:], mask16)], axis=-1)
            n_det = n_det + jnp.sum(
                CRC16.jnp_check(unmasked).astype(jnp.int32))
        ilist = []
        if mimo:
            (b1, b2), (ok1, ok2), _ = pdsch_decode(
                grid, h, cfg, plan, noise_est=n0[:, None], plan2=plan,
                iters_out=ilist)
            ok_sum = jnp.sum(ok1.astype(jnp.int32)) \
                + jnp.sum(ok2.astype(jnp.int32))
            n_bad = bad_bits(b1, tb, ok1) + bad_bits(b2, tb2, ok2)
        else:
            bits, ok, _ = pdsch_decode(
                grid[:, None], h[:, None, None], cfg, plan,
                noise_est=n0[:, None], iters_out=ilist)
            ok_sum = jnp.sum(ok.astype(jnp.int32))
            n_bad = bad_bits(bits, tb, ok)
        n_it = jnp.max(jnp.stack(ilist)) if ilist \
            else jnp.zeros((), jnp.int32)
        good = ok_sum + jnp.minimum(cfi_ok, batch) \
            + jnp.minimum(n_det, batch)
        return good.astype(jnp.int32), n_it, n_bad

    make_tx_j = jax.jit(make_tx)
    nshape = (batch, 2, sf_len) if mimo else (batch, sf_len)
    nz_re = jnp.asarray(rng.normal(size=nshape).astype(np.float32))
    nz_im = jnp.asarray(rng.normal(size=nshape).astype(np.float32))
    s_re, s_im = make_tx_j(jnp.asarray(tb), jnp.asarray(tb2),
                           jnp.asarray(np.real(h2)),
                           jnp.asarray(np.imag(h2)), nz_re, nz_im)
    args = (s_re, s_im, jnp.asarray(tb), jnp.asarray(tb2))

    @jax.jit
    def chained(s_re, s_im, tb, tb2):
        # scalar cross-call carry (see bench_turbo note)
        def body(carry, _):
            eps, acc, itm, bad = carry
            n_good, n_it, n_bad = fn(
                s_re + (0.0 * eps).astype(s_re.dtype), s_im, tb, tb2)
            return (n_bad.astype(jnp.float32), acc + n_good,
                    jnp.maximum(itm, n_it), bad + n_bad), None
        zi = jnp.zeros((), jnp.int32)
        (_, acc, itm, bad), _ = jax.lax.scan(
            body, (jnp.zeros((), jnp.float32), zi, zi, zi), None,
            length=chain)
        return acc, itm, bad

    chained = chained.lower(*args).compile()
    acc, itm, bad = chained(*args)
    n_good = _sync(acc)
    n_it = _sync(itm)
    n_bad = _sync(bad)
    best_mbps = best_sfps = 0.0
    for _ in range(3):
        reps = 2
        t0 = time.time()
        r = None
        for _ in range(reps):
            r = chained(*args)
        jax.block_until_ready(r)
        dt = (time.time() - t0) / (reps * chain)
        if batch * n_cw * tbs / dt / 1e6 > best_mbps:
            best_mbps = batch * n_cw * tbs / dt / 1e6
            best_sfps = batch / dt
    # good counts: pdsch ok (n_cw*batch) + cfi (batch) + dci (batch)
    return {"mbps": round(best_mbps, 0), "sfps": round(best_sfps, 0),
            "crc_ok": n_good == (n_cw + 2) * batch * chain,
            "tb_exact": n_bad == 0, "iters": n_it,
            "memory": memory_summary(chained)}


def bench_latency():
    """Latency of the FULL no-genie ue_dl chain (20 MHz 2x2 TM4, the
    reference's headline configuration) at small batch, against the
    reference's real-time budget: subframes arrive every 1 ms and the
    decode-to-ACK deadline is 4 ms (srsenb/src/phy/txrx.cc:122-126,
    HARQ_DELAY_MS=4 at lib/include/srslte/common/common.h:49).

    ms/call is steady-state per-dispatch device time (chained, honest
    readback sync — the throughput methodology at batch 1/8). A batch of
    B subframes collected over B ms and processed in T ms meets the
    deadline for its OLDEST subframe iff (B - 1) + T <= 4 ms; the keys
    below let the reader place the throughput-optimal batch (256)
    against the deadline-feasible ones.

    At every batch the GPU runs the same fused-feed + NII kernel path;
    the kernel tile shrinks to the batch (sch._fused_geometry).
    """
    out = {}
    for b in (1, 8):
        r = bench_uedl(batch=b, mimo=True)
        require(r["crc_ok"] and r["tb_exact"],
                f"uedl latency batch {b}: every CRC passes", r)
        sfps = r["sfps"]
        ms = round(b / sfps * 1e3, 3) if sfps else None
        out[f"uedl_latency_b{b}_ms"] = ms
        out[f"uedl_latency_b{b}_deadline_ok"] = (
            ms is not None and (b - 1) + ms <= 4.0)
    return out


def bench_tx(batch: int = 256, chain: int = 24):
    """eNB DL transmit: DL-SCH encode -> scramble -> modulate -> layer
    map/precode -> RE map + CRS -> iFFT to time samples, 20 MHz 2x2 TM4
    two codewords (srslte_enb_dl: put_base + put_pdsch + gen_signal;
    ENCODED Mbps as printed by pdsch_test.c:455)."""
    from empower_srslte_tpu.models import ra
    from empower_srslte_tpu.models.enb_dl import (enb_dl_base_grid,
                                                  enb_dl_gen_signal)
    from empower_srslte_tpu.models.pdsch import (PdschConfig, pdsch_encode)
    from empower_srslte_tpu.ops.equalizer import MimoType
    from empower_srslte_tpu.utils import Cell

    rng = np.random.default_rng(3)
    cell = Cell(nof_prb=100, nof_ports=2, id=1)
    mod, tbs = ra.mcs_to_tbs(27, 100)
    cfg = PdschConfig(cell=cell, sf_idx=1, cfi=1, mod=mod,
                      mimo=MimoType.SPATIAL_MUX, nof_layers=2,
                      nof_codewords=2)
    plan = cfg.plan(tbs)
    tb = jnp.asarray(rng.integers(0, 2, size=(batch, tbs)).astype(np.int8))
    tb2 = jnp.asarray(rng.integers(0, 2, size=(batch, tbs)).astype(np.int8))

    def fn(tb, tb2):
        grid = enb_dl_base_grid(cell, 1, batch_shape=(batch,))
        grid = grid + pdsch_encode(tb, cfg, plan, tb2, plan)
        samples = enb_dl_gen_signal(grid, cell)
        # reduce over EVERY output sample: a strided/sliced consumption
        # lets XLA dead-code whole branches of the encode (e.g. the
        # second antenna's iFFT) and under-measure the work
        return jnp.sum(jnp.abs(samples))

    @jax.jit
    def chained(tb, tb2):
        # cross-call carry via signbit: a DYNAMIC zero (the sum of
        # magnitudes is provably >= 0 to us, not to XLA). An `x * 0`
        # int dependency gets constant-folded and the whole body
        # loop-hoisted — measured as an impossible 12x jump.
        def body(carry, _):
            eps, acc = carry
            tbx = jnp.bitwise_xor(tb, jnp.signbit(eps).astype(tb.dtype))
            s = fn(tbx, tb2)
            return (s, acc + s), None
        (_, acc), _ = jax.lax.scan(
            body, (jnp.zeros((), jnp.float32), jnp.zeros((), jnp.float32)),
            None, length=chain)
        return acc

    chained = chained.lower(tb, tb2).compile()
    r = chained(tb, tb2)
    finite = bool(np.isfinite(float(np.asarray(r))))
    best_mbps = 0.0
    for _ in range(3):
        reps = 2
        t0 = time.time()
        for _ in range(reps):
            r = chained(tb, tb2)
        jax.block_until_ready(r)
        dt = (time.time() - t0) / (reps * chain)
        best_mbps = max(best_mbps, 2 * tbs * batch / dt / 1e6)
    return {"mbps": round(best_mbps, 0), "finite": finite,
            "memory": memory_summary(chained)}


def main():
    """Receivers first, then the full-chain UE, TX and latency phases,
    the turbo headline last. The cumulative JSON is printed after every
    phase; a failed check (a CRC, a TB, a bit error, a non-finite
    sample) or an exception in any phase ends the run with a non-zero
    exit code. Set BENCH_QUICK=1 to run the turbo phase only."""
    t_start = time.time()
    dev = jax.devices()[0]
    out = {"platform": dev.platform, "device_kind": dev.device_kind,
           "device_count": len(jax.devices()), "card": card_info()}

    def checkpoint():
        print(json.dumps(out), flush=True)

    if not os.environ.get("BENCH_QUICK"):
        for config in ("20mimo", "10siso", "20ul"):
            t0 = time.time()
            r = bench_receiver(config)
            require(r["crc_ok"] and r["tb_exact"],
                    f"rx_{config}: every CRC passes and every TB is exact", r)
            out[f"rx_{config}_mbps"] = r["mbps"]
            out[f"rx_{config}_sfps"] = r["sfps"]
            out[f"rx_{config}_iters"] = r["iters"]
            out[f"rx_{config}_vs_baseline"] = round(
                r["mbps"] / RX_BASELINE[config], 1)
            out[f"t_rx_{config}_s"] = round(time.time() - t0, 1)
            checkpoint()
        # mid-SNR operating points (waterfall edge: the early stop
        # actually iterates; BLER + iteration depth captured, config 2/3/4
        # analog of phy_dl_test.c:371-408 operating-SNR sweeps)
        for config in ("20mimo", "10siso", "20ul"):
            t0 = time.time()
            r = bench_receiver(config, midsnr=True)
            require(r["tb_exact"] and r["bler"] < 1.0,
                    f"rx_{config}_mid: some TB decodes and every TB whose "
                    "CRC passes is exact", r)
            out[f"rx_{config}_mid_mbps"] = r["mbps"]
            out[f"rx_{config}_mid_bler"] = r["bler"]
            out[f"rx_{config}_mid_iters"] = r["iters"]
            out[f"t_rx_{config}_mid_s"] = round(time.time() - t0, 1)
            checkpoint()

        # full-chain UE DL (no genie channel: FFT + LS chest + PCFICH +
        # blind PDCCH + PDSCH; SISO and the reference's 20 MHz MIMO
        # headline configuration) and the eNB TX side
        uedl_phases = (("rx_uedl", dict(), 36.0),
                       ("rx_uedl_20mimo", dict(mimo=True), 150.0))
        for name, kw, base in uedl_phases:
            t0 = time.time()
            r = bench_uedl(**kw)
            require(r["crc_ok"] and r["tb_exact"],
                    f"{name}: every CRC passes and every TB is exact", r)
            out[f"{name}_mbps"] = r["mbps"]
            out[f"{name}_sfps"] = r["sfps"]
            out[f"{name}_iters"] = r["iters"]
            out[f"{name}_vs_baseline"] = round(r["mbps"] / base, 1)
            out[f"t_{name}_s"] = round(time.time() - t0, 1)
            checkpoint()
        t0 = time.time()
        r = bench_tx()
        require(r["finite"], "tx_20mimo: samples finite", r)
        out["tx_20mimo_mbps"] = r["mbps"]
        out["tx_20mimo_vs_baseline"] = round(r["mbps"] / 150.0, 1)
        out["t_tx_20mimo_s"] = round(time.time() - t0, 1)
        checkpoint()
        # real-time latency point (4 ms HARQ deadline comparison)
        t0 = time.time()
        out.update(bench_latency())
        out["t_latency_s"] = round(time.time() - t0, 1)
        checkpoint()

    t0 = time.time()
    mbps, errs, batch = bench_turbo()
    require(errs == 0, "turbo decode: 0 bit errors at Eb/N0 1.5 dB",
            {"mbps": mbps, "bit_errors": errs})
    out.update({
        "metric": "turbo_decode_throughput_k6144_5it",
        "value": mbps,
        "unit": "Mbps",
        "vs_baseline": round(mbps / BASELINE_MBPS, 2),
        "bit_errors": errs,
        "batch": batch,
        "t_turbo_s": round(time.time() - t0, 1),
        "t_total_s": round(time.time() - t_start, 1),
    })
    checkpoint()


if __name__ == "__main__":
    main()
