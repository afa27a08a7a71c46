"""Central JAX runtime setup.

Importing this module enables x64 (the host oracle and the reference's
Eigen EM are float64; bit-parity tests need f64 on device). Kernels that
want f32 request it explicitly. The backend follows JAX_PLATFORMS.

Persistent compilation cache: where JAX_COMPILATION_CACHE_DIR is set, JAX
reads it itself and nothing is set here; otherwise the cache lives at a
fixed path inside the checkout (`<repo>/.jax_cache`), so every process of
one checkout finds the kernels an earlier one compiled.
"""
import os
import shutil
import subprocess

import jax

jax.config.update("jax_enable_x64", True)

CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".jax_cache")

if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def device_info() -> dict:
    """Platform, kind and count of the devices the kernels run on (starts
    the backend if nothing has yet)."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card() -> str:
    """nvidia-smi's name and power limit of the first card ("no NVIDIA GPU"
    where there is none). Never touches JAX, so a parent process can name
    the card its children use."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "no NVIDIA GPU"
    r = subprocess.run([exe, "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    lines = r.stdout.strip().splitlines()
    return lines[0].strip() if r.returncode == 0 and lines else "no NVIDIA GPU"
