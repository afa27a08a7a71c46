"""Runtime set-up: the compile cache location, one device per distributed
process, and the CLI's device switch."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


@pytest.mark.parametrize("from_env", [False, True])
def test_compile_cache_dir(tmp_path, from_env):
    """JAX_COMPILATION_CACHE_DIR wins and nothing overrides it; without it
    the cache sits at a fixed path inside the checkout."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if from_env:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import jax\n"
            "from strawberry_tpu.utils import jaxsetup\n"
            "print(jax.config.jax_compilation_cache_dir)\n" % ROOT)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    got = r.stdout.strip().splitlines()[-1]
    want = str(tmp_path / "cache") if from_env \
        else os.path.join(ROOT, ".jax_cache")
    assert got == want


@pytest.mark.parametrize("hosts,per_host", [(1, 4), (2, 4)])
def test_init_distributed_binds_one_local_device(monkeypatch, hosts,
                                                 per_host):
    """Each process binds one card of its own host: local card k % 4 for
    global process k, on one host or across two 4-card hosts."""
    import jax
    from strawberry_tpu.parallel.collectives import init_distributed
    calls = []
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: calls.append(kw))
    init_distributed("localhost:1234", 1, 0)
    assert calls == []  # one process: nothing to join
    n = hosts * per_host
    for k in range(n):
        init_distributed("localhost:1234", n, k,
                         per_host if hosts > 1 else 0)
    assert calls == [
        dict(coordinator_address="localhost:1234", num_processes=n,
             process_id=k, local_device_ids=[k % per_host])
        for k in range(n)]


def test_cli_passes_procs_per_host(monkeypatch):
    """The launcher's STRAWB_DIST_* variables reach init_distributed."""
    from strawberry_tpu import cli
    from strawberry_tpu.parallel import collectives
    calls = []
    monkeypatch.setattr(collectives, "init_distributed",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("STRAWB_DIST_COORD", "localhost:1234")
    monkeypatch.setenv("STRAWB_DIST_NPROCS", "8")
    monkeypatch.setenv("STRAWB_DIST_PROCID", "5")
    monkeypatch.setenv("STRAWB_DIST_PROCS_PER_HOST", "4")
    assert cli._maybe_init_distributed() == 5
    assert calls == [("localhost:1234", 8, 5, 4)]


@pytest.mark.parametrize("flag", ["", "--no-device", "--no-tpu"])
def test_cli_device_switch(flag):
    from strawberry_tpu.cli import build_parser, config_from_args
    argv = ([flag] if flag else []) + ["x.bam"]
    cfg = config_from_args(build_parser().parse_args(argv))
    assert cfg.device_batch is (flag == "")
