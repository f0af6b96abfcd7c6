"""Pytest configuration: run all tests on a virtual 8-device CPU mesh.

Multi-device sharding (parallel/) is validated on
``--xla_force_host_platform_device_count=8`` CPU devices; single-device
numerics tests run on CPU device 0. Tests marked ``gpu`` skip here;
``python chip_smoke.py`` runs them on the card (it sets
SRSLTE_TEST_ON_DEVICE so that this file leaves the platform alone).
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

if not os.environ.get("SRSLTE_TEST_ON_DEVICE"):
    jax.config.update("jax_platforms", "cpu")

# Persistent compilation cache: the integration tests compile hundreds of
# small XLA programs (per-subframe pipeline stages); caching them on disk
# makes re-runs start warm and sidesteps an intermittent XLA-CPU compiler
# segfault seen after many in-process compilations.
from empower_srslte_tpu.backend import configure_compile_cache  # noqa: E402

configure_compile_cache()

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


#: Full-stack integration modules compile hundreds of small per-subframe
#: XLA programs; past ~3 such tests in one process the XLA-CPU executable
#: loader crashes (segfault/abort in backend_compile_and_load /
#: cache read). Dropping the in-memory executables between heavy tests
#: keeps the loader healthy; the persistent compilation cache (above)
#: makes the recompiles cheap.
_HEAVY_MODULES = ("test_stack", "test_tun_gateway", "test_mac_procs",
                  "test_multi_ue", "test_idle_paging", "test_cold_boot",
                  "test_handover_ota", "test_mbms_ota", "test_mimo_stack",
                  "test_idle_reselect", "test_csi_feedback",
                  "test_tau_ota", "test_int8_lane")

#: Modules excluded from the fast tier (`-m "not slow"`): the heavy
#: full-stack modules above plus compile-bound kernel/integration sweeps.
_SLOW_MODULES = _HEAVY_MODULES + (
    "test_turbo", "test_parallel", "test_reference_vectors",
    "test_ue_dl", "test_uplink", "test_pdsch", "test_pmch",
    "test_control_channels", "test_sync", "test_chest_eq",
    "test_rate_matching", "test_measurements", "test_pucch_uci",
    "test_ofdm_modem", "test_mimo_stack", "test_rrc")


def pytest_collection_modifyitems(config, items):
    """Tier markers: `pytest -m "not slow"` is the <60 s fast tier
    covering the host-side protocol stack (NAS/RLC/PDCP/S1AP/GTP/RRC
    codecs, MME/HSS/SP-GW, scheduler, config, IO framing)."""
    for item in items:
        mod = item.module.__name__.split(".")[-1]
        if mod in _SLOW_MODULES:
            item.add_marker(pytest.mark.slow)


#: count of heavy tests since the last executable shed; the XLA-CPU
#: loader degrades past ~3-4 full-stack tests' worth of in-process
#: loads, so shed every 2nd heavy test instead of every test — one
#: attach re-loads ~450 programs (~40 s even from the persistent
#: cache), so amortizing the shed halves the heavy modules' wall time.
_heavy_since_clear = 0


@pytest.fixture(autouse=True)
def _clear_jax_caches_between_heavy_tests(request):
    yield
    global _heavy_since_clear
    if request.module.__name__.split(".")[-1] in _HEAVY_MODULES:
        _heavy_since_clear += 1
        if _heavy_since_clear < 2:
            return
        _heavy_since_clear = 0
        jax.clear_caches()
        for mod_name in list(sys.modules):
            if mod_name.startswith("empower_srslte_tpu"):
                mod = sys.modules[mod_name]
                for attr in ("_jit_cache", "_front_cache", "_pdsch_cache",
                             "_pdcch_llr_cache", "_phich_cache"):
                    cache = getattr(mod, attr, None)
                    if isinstance(cache, dict):
                        cache.clear()


def tti_hygiene(tti: int, period: int = 150) -> None:
    """Shed in-memory XLA executables inside long TTI loops.

    The XLA-CPU executable loader degrades after hundreds of in-process
    compiles/loads (see _HEAVY_MODULES above); long OTA tests call this
    once per TTI instead of scattering ad-hoc jax.clear_caches() calls.
    The persistent compilation cache makes the reloads cheap.
    """
    if tti and tti % period == 0:
        jax.clear_caches()
