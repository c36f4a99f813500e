"""Process-level JAX setup shared by the entry points: which platform a run
is on, and where compiled programs are cached.

A measurement must run on the accelerator it reports. JAX falls back to the
CPU with only a warning when its GPU plugin fails to start, so
:func:`require_platform` accepts the CPU only when the caller asked for it
explicitly (``jax_platforms`` set to ``cpu``, as the tests and ``--platform
cpu`` do) and otherwise insists on the GPU.
"""

from __future__ import annotations

import os
from pathlib import Path

PLATFORMS = ("cpu", "gpu")

REPO_ROOT = Path(__file__).resolve().parent.parent
DEFAULT_CACHE_DIR = REPO_ROOT / ".jax_cache"


# Published dense bf16 peak of each card the program measures on (NVIDIA
# H100 data sheet, SXM part, without sparsity; reached only at the card's
# full 700 W power limit). A card missing here is an error, not a default.
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def peak_bf16_flops(device):
    """The bf16 peak FLOP/s of a JAX ``device`` for MFU ratios; None on the
    CPU, whose runs report no device utilization. Raises KeyError for a
    GPU that is not in :data:`PEAK_BF16_FLOPS`."""
    if device.platform == "cpu":
        return None
    try:
        return PEAK_BF16_FLOPS[device.device_kind]
    except KeyError:
        raise KeyError(
            f"no published bf16 peak for {device.device_kind!r}; add it "
            "to runtime.PEAK_BF16_FLOPS with its source"
        ) from None


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory:
    ``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<repo>/.jax_cache``.
    The path is fixed (it is part of the cache key), never per run."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        DEFAULT_CACHE_DIR
    )
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def force_platform(platform: str) -> None:
    """Pin JAX to ``platform`` ('cpu' or 'gpu'); call before first use."""
    import jax

    if platform not in PLATFORMS:
        raise ValueError(
            f"unknown platform {platform!r}; choose one of {PLATFORMS}"
        )
    jax.config.update("jax_platforms", "cuda" if platform == "gpu"
                      else platform)


def decide_platform(platform: str, jax_platforms) -> str:
    """The platform a run may go on, given the backend JAX found
    (``platform``) and the platforms it was asked for (``jax_platforms``):
    'gpu', or 'cpu' only when the CPU was asked for alone. Raises on a
    silent CPU fallback and on any other backend."""
    if platform == "gpu":
        return platform
    if platform == "cpu" and jax_platforms == "cpu":
        return platform
    raise RuntimeError(
        f"expected a GPU, found platform {platform!r} "
        f"(jax_platforms={jax_platforms!r}); force the CPU explicitly for "
        "a CPU run"
    )


def require_platform() -> str:
    """:func:`decide_platform` for this process's first device."""
    import jax

    return decide_platform(jax.devices()[0].platform,
                           jax.config.jax_platforms)
