#!/usr/bin/env python
"""Smoke test of the LTE PHY main path on NVIDIA GPUs.

  python chip_smoke.py              one card: the apps, the flagship
                                    batch-256 programs, the Pallas kernels
                                    against their plain references, and the
                                    tests marked ``gpu``
  python chip_smoke.py --devices 4  four cards: the (carrier, sf)-sharded
                                    20 MHz 2x2 step and the trellis-sharded
                                    NII decode, each against one card

One process drives the card(s). Every phase raises on failure, so any
failed check ends the run with a non-zero exit code and no result line.
The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def say(*parts) -> None:
    print(*parts, flush=True)


def median_ms(fn, *args, n: int = 7) -> float:
    """Median of ``n`` warm runs, each ended by block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def _load_app(name: str):
    path = os.path.join(ROOT, "apps", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"app_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _compile_ue_programs(path: str, nof_prb: int, rnti: int = 0x1234):
    """Compile the UE's per-subframe-index programs (one set for each of
    the 10 subframe indices) from 10 threads at once, so that the app's
    own loop runs on compiled programs: XLA compiles outside the GIL."""
    from concurrent.futures import ThreadPoolExecutor

    from empower_srslte_tpu.models.ue_dl import ue_dl_decode
    from empower_srslte_tpu.models.ue_sync import sync_and_align
    from empower_srslte_tpu.runtime.io import FileSource
    from empower_srslte_tpu.utils import Cell

    res = sync_and_align(FileSource(path).read_all(), cell_prb=nof_prb)
    cell = Cell(nof_prb=nof_prb, id=res.cell_id)
    with ThreadPoolExecutor(10) as pool:
        list(pool.map(lambda i: ue_dl_decode(res.subframes[i], cell, i % 10,
                                             rnti), range(10)))


def phase_apps(nof_prb: int = 100, mcs: int = 27, frames: int = 10) -> None:
    """(a) The eNB generator and the UE receiver apps, in this process:
    cell search, MIB and per-subframe ue_dl, every PDSCH CRC passing."""
    enb, ue = _load_app("pdsch_enodeb"), _load_app("pdsch_ue")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "enb.bin")
        t0 = time.time()
        enb.main(["-o", path, "-p", str(nof_prb), "-m", str(mcs),
                  "-f", str(frames)])
        t1 = time.time()
        _compile_ue_programs(path, nof_prb)
        t2 = time.time()
        res = ue.main(["-i", path, "-p", str(nof_prb),
                       "-n", str(10 * frames)])
    say(f"apps: enodeb {t1 - t0:.1f}s, ue compile {t2 - t1:.1f}s, "
        f"ue {time.time() - t2:.1f}s:",
        json.dumps({k: v for k, v in res.items() if k != "mib"}),
        "mib", res["mib"])
    check(res["mib"] is not None and res["mib"]["nof_prb"] == nof_prb,
          "MIB decoded with the cell bandwidth")
    check(res["subframes"] >= 10 * frames - 10, "subframes aligned")
    check(res["tbs"] == res["subframes"], "a DCI and PDSCH in every subframe")
    check(res["crc_errors"] == 0, "every PDSCH CRC passes")


def phase_flagship(batch: int = 256, chain: int = 1) -> None:
    """(b) The batch-256 flagship programs through the default decoder.

    The four programs are built from four threads at once, so that their
    compiles (minutes each when the cache is cold) overlap; their Mbps
    are therefore not measurements (bench.py runs them one at a time)."""
    from concurrent.futures import ThreadPoolExecutor

    import bench

    def timed(call):
        t0 = time.time()
        return call(), time.time() - t0

    calls = (
        ("rx_20mimo", lambda: bench.bench_receiver("20mimo", batch, chain)),
        ("rx_uedl_20mimo", lambda: bench.bench_uedl(batch, chain,
                                                    mimo=True)),
        ("rx_20ul", lambda: bench.bench_receiver("20ul", batch, chain)),
        ("tx_20mimo", lambda: bench.bench_tx(batch, chain)))
    with ThreadPoolExecutor(len(calls)) as pool:
        done = list(pool.map(lambda nc: timed(nc[1]), calls))
    for (name, _call), (r, secs) in zip(calls, done):
        say(f"{name}: {secs:.1f}s", json.dumps(r))
        if name == "tx_20mimo":
            check(r["finite"], "TX samples finite")
        else:
            check(r["crc_ok"], f"{name}: every CRC passes")
            check(r["tb_exact"], f"{name}: every TB equals the sent one")


def nii_kernel_check(t_tiles: int = 8, k: int = 6144, l: int = 256,
                     lanes: int = 256, interpret: bool = False,
                     timing: bool = True) -> dict:
    """The NII kernel against map_decode_nii_ref in float32 (both
    outputs and boundary metrics bit-identical), at K=6144 and
    T*lanes = 2048 code blocks on the card."""
    import jax
    import jax.numpy as jnp

    from empower_srslte_tpu.ops.fec.turbo_decoder_pallas2 import (
        map_decode_nii, map_decode_nii_ref)

    rng = np.random.default_rng(11)
    w = k // l
    f = lambda *s: jnp.asarray((rng.normal(size=s) * 4).astype(np.float32))
    u, p, e = (f(t_tiles, k, 1, lanes) for _ in range(3))
    ut, pt = f(t_tiles, 8, 1, lanes), f(t_tiles, 8, 1, lanes)
    a, b = f(t_tiles, w + 1, 8, 1, lanes), f(t_tiles, w + 1, 8, 1, lanes)
    args = (u, p, ut, pt, a, b, e)
    kern = jax.jit(lambda u, p, ut, pt, a, b, e: map_decode_nii(
        u, p, ut, pt, a, b, l=l, apr=e, interpret=interpret))
    ref = jax.jit(lambda u, p, ut, pt, a, b, e: map_decode_nii_ref(
        u, p, ut, pt, a, b, l=l, apr=e))
    got, want = kern(*args), ref(*args)
    same = [bool(np.array_equal(np.asarray(x), np.asarray(y)))
            for x, y in zip(got, want)]
    diff = float(np.max(np.abs(np.asarray(got[0]) - np.asarray(want[0]))))
    out = {"bit_identical": same, "ext_max_abs_diff": diff}
    if timing:
        out["kernel_ms"] = median_ms(kern, *args)
        out["xla_ref_ms"] = median_ms(ref, *args)
    check(all(same) and diff == 0.0, "NII kernel bit-identical to ref (f32)")
    return out


def turbo_decode_check(batch: int = 2048, k: int = 6144,
                       timing: bool = True) -> dict:
    """The default (bf16 NII kernel) decode at Eb/N0 1.5 dB, 5
    iterations: 0 bit errors; timed against the XLA scan decoder."""
    import jax
    import jax.numpy as jnp

    from empower_srslte_tpu.ops.fec import TurboDecoder, turbo_encode_np

    rng = np.random.default_rng(0)
    u0 = rng.integers(0, 2, size=(batch // 8, k)).astype(np.int8)
    u = np.tile(u0, (8, 1))
    d = np.tile(turbo_encode_np(u0), (8, 1, 1))
    n0 = 1.0 / (10 ** 0.15 / 3)
    y = 1 - 2 * d.astype(np.float64) \
        + np.sqrt(n0 / 2) * rng.normal(size=d.shape)
    llr = jnp.asarray((4 / n0 * y).astype(np.float32))
    out = {}
    for impl in ("auto", "xla"):
        dec = TurboDecoder(k=k, iterations=5, window=256, impl=impl)
        fn = jax.jit(lambda x, dec=dec: dec.decode(x)[0])
        errs = int(np.sum(np.asarray(fn(llr)) != u))
        out[f"{impl}_bit_errors"] = errs
        if timing:
            out[f"{impl}_ms"] = median_ms(fn, llr, n=5)
        check(errs == 0, f"turbo decode impl={impl}: 0 bit errors")
    return out


def viterbi_check(batch: int = 256, interpret: bool = False,
                  timing: bool = True) -> dict:
    """The Viterbi kernel against the scan at the 20 MHz PDCCH candidate
    set (both DCI sizes, every UE-search candidate): decisions
    bit-identical."""
    import jax
    import jax.numpy as jnp

    from empower_srslte_tpu.models.dci import format0_1a_size, format1_size
    from empower_srslte_tpu.models.pdcch import ue_search_candidates
    from empower_srslte_tpu.models.regs import pdcch_nof_cces
    from empower_srslte_tpu.ops.fec.convcoder import (conv_encode_np,
                                                      viterbi_decode)
    from empower_srslte_tpu.ops.fec.viterbi_pallas import (
        viterbi_decode_pallas)
    from empower_srslte_tpu.utils import Cell

    cell = Cell(nof_prb=100, nof_ports=2, id=1)
    n_cand = len(ue_search_candidates(0x1234, 1, pdcch_nof_cces(cell, 1)))
    rng = np.random.default_rng(5)
    out = {}
    for size in (format1_size(100), format0_1a_size(100)):
        k = size + 16
        u = rng.integers(0, 2, size=(batch * n_cand, k)).astype(np.int8)
        d = conv_encode_np(u).astype(np.float32)
        llr = jnp.asarray(((1 - 2 * d) + 0.8 * rng.normal(size=d.shape))
                          .astype(np.float32).reshape(batch, n_cand, 3, k))
        kern = jax.jit(lambda x: viterbi_decode_pallas(x, interpret=interpret))
        scan = jax.jit(lambda x: viterbi_decode(x, impl="scan"))
        same = bool(np.array_equal(np.asarray(kern(llr)),
                                   np.asarray(scan(llr))))
        out[f"k{k}_identical"] = same
        if timing:
            out[f"k{k}_kernel_ms"] = median_ms(kern, llr)
            out[f"k{k}_scan_ms"] = median_ms(scan, llr)
        check(same, f"Viterbi kernel decisions equal the scan (k={k})")
    return out


def encoder_ks(sample: int = 47) -> list[int]:
    """The turbo code-block sizes of the flagship and app transport
    blocks, and every ``sample``-th of the 188 LTE sizes (ends kept)."""
    from empower_srslte_tpu.models import ra
    from empower_srslte_tpu.ops.fec import TURBO_CB_SIZES
    from empower_srslte_tpu.ops.fec.cbsegm import cbsegm

    ks = set(TURBO_CB_SIZES[::sample]) | {TURBO_CB_SIZES[-1]}
    for mcs, n_prb, dl in ((27, 100, True), (25, 100, True),
                           (20, 96, False), (23, 50, True),
                           (27, 98, True)):     # pdsch_enodeb at 100 PRB
        s = cbsegm(ra.mcs_to_tbs(mcs, n_prb, dl=dl)[1])
        ks |= {k for k, n in ((s.k_plus, s.c_plus), (s.k_minus, s.c_minus))
               if n}
    return sorted(ks)


def encoder_check(ks=None, batch: int = 64, big: int = 5632,
                  k_big: int = 5824, timing: bool = True) -> dict:
    """turbo_encode on the card against turbo_encode_np, every output bit
    (tail columns included): ``batch`` code blocks at each K of
    encoder_ks(), and ``big`` code blocks (the 11 CBs x 2 codewords x 256
    subframes of tx_20mimo) at the flagship's ``k_big``."""
    import jax
    import jax.numpy as jnp

    from empower_srslte_tpu.ops.fec import turbo_encode, turbo_encode_np

    ks = sorted(set(encoder_ks() if ks is None else ks) | {k_big})
    rng = np.random.default_rng(13)
    enc = jax.jit(turbo_encode)
    bad, inputs = {}, {}
    for k in ks:
        u = rng.integers(0, 2, size=(big if k == k_big else batch, k))
        inputs[k] = jnp.asarray(u.astype(np.int8))
        n = int(np.sum(np.any(np.asarray(enc(inputs[k]))
                              != turbo_encode_np(u), axis=(-2, -1))))
        if n:
            bad[k] = n
    out = {"ks": len(ks), "k_min": min(ks), "k_max": max(ks),
           "blocks_wrong": bad}
    if timing:
        out[f"b{big}_k{k_big}_ms"] = median_ms(enc, inputs[k_big])
    check(not bad,
          "turbo_encode on the card equals turbo_encode_np bit for bit")
    return out


def llr_check(batch: int = 4) -> dict:
    """Equalizer + soft demapper LLRs of a 20 MHz 2x2 TM4 subframe on the
    card against the same inputs on the host CPU backend.

    Tolerance: 1e-5 of the largest |LLR|, about 12x the largest
    difference read on an H100 (8.6e-7; the backends round divisions and
    square roots differently). A control run on the card from inputs
    rounded to bfloat16 must miss that tolerance by 10x, so the check can
    see an error of that size. No LLR above the tolerance may change
    sign."""
    import jax
    import jax.numpy as jnp

    from empower_srslte_tpu.models import ra
    from empower_srslte_tpu.models.pdsch import (PdschConfig, pdsch_encode,
                                                 pdsch_extract)
    from empower_srslte_tpu.ops.equalizer import MimoType, eq_mux_2x2
    from empower_srslte_tpu.ops.modem import demod_soft
    from empower_srslte_tpu.utils import Cell

    tol = 1e-5
    cell = Cell(nof_prb=100, nof_ports=2, id=1)
    mod, tbs = ra.mcs_to_tbs(27, 100)
    cfg = PdschConfig(cell=cell, sf_idx=1, cfi=1, mod=mod,
                      mimo=MimoType.SPATIAL_MUX, nof_layers=2,
                      nof_codewords=2)
    plan = cfg.plan(tbs)
    rng = np.random.default_rng(9)
    tb = rng.integers(0, 2, size=(2, batch, tbs)).astype(np.int8)
    cpu = jax.devices("cpu")[0]
    on = lambda dev, *vs: [jax.device_put(jnp.asarray(v), dev) for v in vs]
    ports = np.asarray(jax.jit(
        lambda a, b: pdsch_encode(a, cfg, plan, b, plan))(
            *on(jax.devices()[0], tb[0], tb[1])))
    # per-subframe well-conditioned 2x2 channel (as bench_uedl's)
    ph = rng.uniform(0, 2 * np.pi, size=(batch, 2, 2))
    mag = np.where(np.eye(2, dtype=bool)[None], 1.0, 0.35)
    h2 = (mag * np.exp(1j * ph)).astype(np.complex64)
    h = np.broadcast_to(h2[..., None, None],
                        (batch, 2, 2, 14, 1200)).astype(np.complex64)
    y = np.einsum("brpsk,bpsk->brsk", h, ports) + 0.03 * (
        rng.normal(size=(batch, 2, 14, 1200))
        + 1j * rng.normal(size=(batch, 2, 14, 1200)))

    def llrs(y, h):
        ye = pdsch_extract(y, cfg)
        he = jnp.stack([jnp.stack([pdsch_extract(h[:, r, p], cfg)
                                   for p in range(2)], 1)
                        for r in range(2)], 1)
        x, _csi = eq_mux_2x2(ye, he, 1e-3)
        return demod_soft(x, mod)

    y = y.astype(np.complex64)
    bf16 = lambda v: (v.real.astype(jnp.bfloat16).astype(np.float32)
                      + 1j * v.imag.astype(jnp.bfloat16).astype(np.float32)
                      ).astype(np.complex64)
    llrs = jax.jit(llrs)
    got = np.asarray(llrs(*on(jax.devices()[0], y, h)))
    want = np.asarray(llrs(*on(cpu, y, h)))
    ctl = np.asarray(llrs(*on(jax.devices()[0], bf16(y), bf16(h))))
    scale = float(np.max(np.abs(want)))
    err = np.abs(got - want)
    big = np.abs(want) > tol * scale
    out = {"n_llr": int(want.size), "max_abs_llr": scale,
           "max_rel_diff": float(np.max(err)) / scale,
           "p99_rel_diff": float(np.percentile(err, 99)) / scale,
           "bf16_control_max_rel_diff":
               float(np.max(np.abs(ctl - want))) / scale,
           "sign_flips_above_tol": int(np.sum(
               (np.sign(got) != np.sign(want)) & big))}
    say("demap_llr_gpu_vs_cpu:", json.dumps(out))
    check(out["max_rel_diff"] < tol,
          f"GPU LLRs within {tol} of max |LLR| of the CPU's")
    check(out["bf16_control_max_rel_diff"] > 10 * tol,
          "the LLR check sees a bf16 rounding of its inputs")
    check(out["sign_flips_above_tol"] == 0, "no LLR sign flips")
    return out


def phase_kernels() -> None:
    """(c) Kernel checks against the plain references, and timings."""
    from bench import card_info

    card = card_info()
    for name, fn in (("nii_kernel_f32_k6144_b2048", nii_kernel_check),
                     ("turbo_decode_k6144_b2048_1.5dB", turbo_decode_check),
                     ("viterbi_20mhz_pdcch_b256", viterbi_check),
                     ("turbo_encode_vs_numpy", encoder_check),
                     ("demap_llr_gpu_vs_cpu", llr_check)):
        t0 = time.time()
        r = fn()
        say(f"{name}: {time.time() - t0:.1f}s", json.dumps(r), f"[{card}]")


def phase_gpu_tests() -> None:
    """The tests marked ``gpu`` (compiled kernels at test sizes)."""
    import pytest

    class Count:
        passed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                Count.passed += 1

    os.environ["SRSLTE_TEST_ON_DEVICE"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-o", "addopts=", "-p", "no:xdist",
                      "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_gpu_kernels.py")],
                     plugins=[Count()])
    say(f"gpu tests: rc={int(rc)} passed={Count.passed}")
    check(int(rc) == 0 and Count.passed > 0, "tests marked gpu pass")


def sharded_step_check(devices, per_device: int = 16, mcs: int = 27,
                       nof_prb: int = 100) -> dict:
    """The 20 MHz 2x2 TM4 encode -> channel -> decode step with the
    subframe batch sharded over a (carrier, sf) mesh of ``devices``,
    against the same step on devices[0]: decoded bits and CRC flags
    bit-identical."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from empower_srslte_tpu.models import ra
    from empower_srslte_tpu.models.pdsch import (PdschConfig, pdsch_decode,
                                                 pdsch_encode)
    from empower_srslte_tpu.ops.equalizer import MimoType
    from empower_srslte_tpu.parallel import make_mesh
    from empower_srslte_tpu.utils import Cell

    n = len(devices)
    mesh = make_mesh(n, devices=devices)
    n_car, n_sf = mesh.shape["carrier"], mesh.shape["sf"]
    cell = Cell(nof_prb=nof_prb, nof_ports=2, id=1)
    mod, tbs = ra.mcs_to_tbs(mcs, nof_prb)
    cfg = PdschConfig(cell=cell, sf_idx=1, cfi=1, mod=mod,
                      mimo=MimoType.SPATIAL_MUX, nof_layers=2,
                      nof_codewords=2, pmi=0)
    plan = cfg.plan(tbs)
    rng = np.random.default_rng(0)
    lead = (n_car, n_sf * per_device)
    tb = rng.integers(0, 2, size=(*lead, tbs)).astype(np.int8)
    tb2 = rng.integers(0, 2, size=(*lead, tbs)).astype(np.int8)
    nz = (rng.normal(size=(*lead, 2, 2, 14, cell.nof_re)) * 0.02
          ).astype(np.float32)

    def step(tb_bits, tb2_bits, nz):
        ports = pdsch_encode(tb_bits, cfg, plan, tb2_bits, plan)
        hm = jnp.asarray([[0.9 + 0.1j, 0.2 - 0.1j],
                          [-0.15 + 0.2j, 0.85 - 0.05j]], jnp.complex64)
        rx = (jnp.einsum("rp,...psk->...rsk", hm, ports)
              + jax.lax.complex(nz[..., 0, :, :, :], nz[..., 1, :, :, :]))
        h = jnp.broadcast_to(hm[:, :, None, None],
                             (*tb_bits.shape[:-1], 2, 2, 14, cell.nof_re))
        (b1, b2), (ok1, ok2), _ = pdsch_decode(
            rx, h, cfg, plan, noise_est=1e-3, plan2=plan)
        return b1, b2, jnp.logical_and(ok1, ok2)

    spec = P("carrier", "sf")
    shard = NamedSharding(mesh, spec)
    sharded = jax.jit(jax.shard_map(step, mesh=mesh, in_specs=(spec,) * 3,
                                    out_specs=(spec,) * 3, check_vma=False))
    outs = sharded(*(jax.device_put(jnp.asarray(x), shard)
                     for x in (tb, tb2, nz)))
    one = jax.jit(step)(*(jax.device_put(jnp.asarray(x), devices[0])
                          for x in (tb, tb2, nz)))
    placed = sorted(d.id for d in outs[0].sharding.device_set)
    per_shard = {int(np.prod(s.data.shape)) for s in outs[0].addressable_shards}
    same = [bool(np.array_equal(np.asarray(x), np.asarray(y)))
            for x, y in zip(outs, one)]
    out = {"devices": placed, "subframes": int(np.prod(lead)),
           "shard_elems": sorted(per_shard), "identical": same,
           "crc_ok": bool(np.asarray(outs[2]).all()),
           "tb_exact": bool(np.array_equal(np.asarray(outs[0]), tb)
                            and np.array_equal(np.asarray(outs[1]), tb2))}
    check(len(placed) == n, f"step output spread over {n} devices")
    check(per_shard == {outs[0].size // n}, "each device holds 1/n")
    check(all(same), "sharded step bit-identical to one card")
    check(out["crc_ok"] and out["tb_exact"], "sharded step decodes")
    return out


def sharded_nii_check(devices, k: int = 6144, batch: int = 256,
                      interpret: bool = False) -> dict:
    """sp_turbo_decode_nii with the trellis over ``devices`` against the
    single-card kernel decode at the same window: bits and LLRs
    bit-identical."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from empower_srslte_tpu.ops.fec import TurboDecoder, turbo_encode_np
    from empower_srslte_tpu.parallel import sp_turbo_decode_nii
    from empower_srslte_tpu.parallel.turbo_sp import _pick_window

    n = len(devices)
    rng = np.random.default_rng(3)
    u = rng.integers(0, 2, size=(batch, k)).astype(np.int8)
    d = turbo_encode_np(u)
    llr = ((1 - 2 * d.astype(np.float32)) * 2.0
           + 1.6 * rng.normal(size=d.shape)).astype(np.float32)
    mesh = Mesh(np.asarray(devices), axis_names=("sf",))
    fn = jax.jit(lambda x: sp_turbo_decode_nii(
        x, k, mesh, axis="sf", iterations=5, interpret=interpret))
    x = jnp.asarray(llr)
    hlo = fn.lower(x).compile().as_text()
    bits_sp, llr_sp = fn(x)
    impl = "pallas2_interpret" if interpret else "pallas2"
    ref = TurboDecoder(k=k, iterations=5, window=_pick_window(k // n, 16),
                       impl=impl, dtype="float32")
    bits_1, llr_1 = jax.jit(ref.decode)(jax.device_put(x, devices[0]))
    out = {"window": ref.window,
           "collectives": [c for c in ("all-gather", "collective-permute")
                           if c in hlo],
           "bits_identical": bool(np.array_equal(np.asarray(bits_sp),
                                                 np.asarray(bits_1))),
           "llr_identical": bool(np.array_equal(np.asarray(llr_sp),
                                                np.asarray(llr_1))),
           "bit_errors": int(np.sum(np.asarray(bits_sp) != u))}
    check(len(out["collectives"]) == 2, "sharded decode exchanges over cards")
    check(out["bits_identical"] and out["llr_identical"],
          "trellis-sharded NII decode bit-identical to one card")
    return out


def phase_multi(n: int) -> None:
    import jax

    devices = jax.devices()[:n]
    check(len(devices) == n, f"{n} devices present")
    for name, fn in (("sharded_tm4_step", sharded_step_check),
                     ("sharded_nii_decode", sharded_nii_check)):
        t0 = time.time()
        r = fn(devices)
        say(f"{name}: {time.time() - t0:.1f}s", json.dumps(r))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card sharded phases")
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    from bench import card_info
    from empower_srslte_tpu.backend import configure_compile_cache

    configure_compile_cache()
    say(card_info())
    t0 = time.time()
    if args.devices == 4:
        phase_multi(4)
    else:
        for phase in (phase_kernels, phase_apps, phase_flagship,
                      phase_gpu_tests):
            t1 = time.time()
            phase()
            say(f"== {phase.__name__} done in {time.time() - t1:.1f}s")
    say(f"== total {time.time() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
