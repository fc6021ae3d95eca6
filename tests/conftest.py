import jax
import pytest

# Tests run on the single host CPU device. (The multi-device dry-run tests
# spawn subprocesses with XLA_FLAGS; never set it here.)
jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running tests (subprocess dry-runs etc.)")
    config.addinivalue_line(
        "markers", "backends: EngineBackend protocol, backend parity, and "
                   "serving A/B tests (pytest -m backends)")
    config.addinivalue_line(
        "markers", "sharded: mesh-sharded serving tests; in-process variants "
                   "need >= 8 devices (CI runs the suite under XLA_FLAGS="
                   "--xla_force_host_platform_device_count=8), subprocess "
                   "variants set the flag themselves")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the port's CUDA kernels have "
                   "no CPU mode); skipped without one")


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)


def small_wgkv(**kw):
    from repro.configs.base import WGKVConfig

    defaults = dict(enabled=True, w_local=16, tau=0.1, gate_hidden=32,
                    global_budget_frac=1.0, sink=4)
    defaults.update(kw)
    return WGKVConfig(**defaults)


def make_cfg(arch: str = "qwen3-0.6b", **wgkv_kw):
    """Reduced fp32 config with a small WG-KV window for fast CPU tests."""
    from repro.configs import get_reduced_config

    cfg = get_reduced_config(arch).replace(dtype="float32")
    if cfg.wgkv.enabled:
        cfg = cfg.replace(wgkv=small_wgkv(**wgkv_kw))
    return cfg.replace(sliding_window=min(cfg.sliding_window, 32))
