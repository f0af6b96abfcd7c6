"""Multi-process (multi-host) dryrun: host-axis sharding evidence.

Launches N real OS processes, each owning 4 virtual CPU devices, joins
them via ``jax.distributed`` and builds the global (host, carrier, sf)
mesh (parallel/dist.py). Two programs then run with real cross-process
collectives:

  A. the FULL no-genie ue_dl chain (parallel/validate.build_uedl_mini)
     sharded over (host, carrier, sf) — one subframe batch per device —
     with a cross-host ``psum`` of the per-shard decode successes, and
     every process checking its own shards' decoded bits;
  B. the trellis-sharded NII turbo decode (sp_turbo_decode_nii) with
     axis='host': the per-window-edge boundary-metric ``ppermute`` and
     the extrinsic ``all_gather`` cross the process boundary each
     half-iteration, and decoded bits must match the encoder input
     exactly.

This is the "1 card -> 1 host -> N hosts" structural evidence BASELINE
asks for, validated the same way the single-process dryrun validates
in-host sharding. It runs on the CPU only (virtual devices): several
JAX processes cannot share one GPU, whose memory the first one takes.

Usage:  python tools/multihost_dryrun.py [n_processes]   (default 2)
Prints MULTIHOST_OK on success.
"""

import os
import subprocess
import sys

N_LOCAL_DEVICES = 4


def worker(rank: int, nproc: int, port: int) -> None:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={N_LOCAL_DEVICES}"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from empower_srslte_tpu.parallel.dist import (init_distributed,
                                                  make_global_mesh)
    from empower_srslte_tpu.parallel.turbo_sp import sp_turbo_decode_nii
    from empower_srslte_tpu.parallel.validate import build_uedl_mini

    init_distributed(coordinator_address=f"localhost:{port}",
                     num_processes=nproc, process_id=rank)
    assert jax.process_count() == nproc, jax.process_count()
    mesh = make_global_mesh(carriers=1)
    n_host = mesh.shape["host"]
    n_sf = mesh.shape["sf"]

    # --- part A: no-genie ue_dl chain over (host, carrier, sf) ---------
    local_step, tbs = build_uedl_mini(seed=7)
    rng = np.random.default_rng(7)
    tb_np = rng.integers(
        0, 2, size=(n_host, 1, n_sf, tbs)).astype(np.int8)

    spec = P("host", "carrier", "sf")
    shard = NamedSharding(mesh, spec)
    tb = jax.make_array_from_callback(
        tb_np.shape, shard, lambda idx: tb_np[idx])

    def stepped(tb_bits):
        bits, ok = local_step(tb_bits)
        # cross-host collective: global success count
        n_ok_global = jax.lax.psum(
            jnp.sum(ok.astype(jnp.int32)), ("host", "carrier", "sf"))
        return bits, n_ok_global

    fn = jax.jit(jax.shard_map(
        stepped, mesh=mesh, in_specs=(spec,),
        out_specs=(spec, P()), check_vma=False))
    bits, n_ok = fn(tb)
    n_ok_v = int(np.asarray(n_ok.addressable_shards[0].data))
    assert n_ok_v == n_host * n_sf, f"ue_dl ok count {n_ok_v}"
    for s in bits.addressable_shards:
        assert np.array_equal(np.asarray(s.data), tb_np[s.index]), \
            f"rank {rank}: ue_dl TB mismatch at {s.index}"

    # --- part B: trellis-sharded NII turbo decode across hosts ---------
    from empower_srslte_tpu.ops.fec import turbo_encode_np

    k = 1024
    u = rng.integers(0, 2, size=(8, k)).astype(np.int8)
    d = turbo_encode_np(u)
    llr = jnp.asarray((1.0 - 2.0 * d.astype(np.float32)) * 8.0)
    bits_sp, _ = sp_turbo_decode_nii(llr, k, mesh, axis="host",
                                     iterations=2, sub=8, lanes=1,
                                     interpret=True)
    # replicated output: every process can check it fully
    got = np.asarray(bits_sp.addressable_shards[0].data)
    assert got.shape[-1] == k and np.array_equal(
        got.reshape(-1, k)[: u.shape[0]], u), \
        f"rank {rank}: cross-host NII decode mismatch"

    if rank == 0:
        print("MULTIHOST_OK", flush=True)


def main() -> None:
    nproc = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    port = int(os.environ.get("MH_PORT", "29517"))
    # worker deadline; callers wrapping this tool (tests) should use a
    # LARGER outer timeout so the cleanup below still runs
    deadline = int(os.environ.get("MH_TIMEOUT_S", "480"))
    procs = []
    env = dict(os.environ)
    for r in range(nproc):
        env_r = dict(env, MH_ROLE="worker", MH_RANK=str(r),
                     MH_NPROC=str(nproc), MH_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__)], env=env_r,
            stdout=subprocess.PIPE if r == 0 else subprocess.DEVNULL,
            stderr=subprocess.STDOUT))
    import time

    t0 = time.time()
    try:
        # ONE global deadline shared by every wait (per-wait timeouts
        # would accumulate to nproc x deadline and outlive callers'
        # outer timeouts, re-orphaning workers)
        out0, _ = procs[0].communicate(timeout=deadline)
        rcs = [procs[0].returncode]
        for p in procs[1:]:
            rcs.append(p.wait(
                timeout=max(1.0, deadline - (time.time() - t0))))
    except subprocess.TimeoutExpired:
        print(f"FAILED timeout after {deadline}s", flush=True)
        sys.exit(1)
    finally:
        # never orphan workers (they hold the coordinator port and
        # would poison the next run's bind/connect)
        for p in procs:
            if p.poll() is None:
                p.kill()
    text = out0.decode(errors="replace")
    sys.stdout.write(text)
    if any(rcs) or "MULTIHOST_OK" not in text:
        print(f"FAILED rcs={rcs}", flush=True)
        sys.exit(1)


if __name__ == "__main__":
    if os.environ.get("MH_ROLE") == "worker":
        worker(int(os.environ["MH_RANK"]), int(os.environ["MH_NPROC"]),
               int(os.environ["MH_PORT"]))
    else:
        main()
