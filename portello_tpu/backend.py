"""Backend selection for the device path.

One place decides, per JAX backend, how phase-2 batches are dispatched
(``select_dispatch``), which platform ``--device`` pins (``set_platform`` /
``check_platform``), where compiled programs are cached
(``configure_compile_cache``), and which card each ``--local-workers``
process gets (``assign_worker_gpus``).  Nothing here touches a JAX backend
at import.
"""

from __future__ import annotations

import logging
import os
import subprocess
from dataclasses import dataclass

logger = logging.getLogger("portello-tpu")

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# --device value -> jax_platforms value ("auto" keeps JAX's own choice)
_PLATFORMS = {"gpu": "cuda", "cpu": "cpu"}


@dataclass(frozen=True)
class DispatchPlan:
    """How the feed dispatches device batches.

    ``mm``: one-hot-matmul formulation of the small-domain gathers and
    segment sums (kernels/expand.py); False = native gathers.
    ``resident``: the genome stays on the device as a superblock table and
    read rows travel packed (kernels/resident.py); False = per-item window
    tables ("table slots").
    ``shard``: batches split over the local devices (parallel/mesh.py).
    """

    mm: bool
    resident: bool
    shard: bool


# Per-backend (mm, resident) defaults.  GPU: the fastest of the three
# formulations end to end on an H100 — native gathers with table slots
# (PERF.md, "H100 bring-up").  CPU: the same; XLA's CPU backend runs
# gathers faster than small matmuls.
_DEFAULTS = {"gpu": (False, False), "cpu": (False, False)}


def _env_flag(environ, name: str) -> bool | None:
    """PTPU_* override: "1" forces on, "0" off, anything else = default."""
    return {"1": True, "0": False}.get(environ.get(name, ""))


def select_dispatch(backend: str, n_local_devices: int,
                    environ=os.environ) -> DispatchPlan:
    """The dispatch plan for ``backend`` ("gpu" or "cpu", as
    ``jax.default_backend()`` names it) with ``n_local_devices`` devices.

    ``PTPU_MM``, ``PTPU_RESIDENT`` and ``PTPU_SHARD`` (1/0) override the
    defaults; resident slots need host-shift routing, so
    ``PTPU_HOST_SHIFT=0`` turns them off.
    """
    if backend not in _DEFAULTS:
        raise ValueError(
            f"no dispatch plan for JAX backend {backend!r} "
            f"(known: {', '.join(sorted(_DEFAULTS))})"
        )
    mm_default, res_default = _DEFAULTS[backend]
    mm = _env_flag(environ, "PTPU_MM")
    mm = mm_default if mm is None else mm
    resident = _env_flag(environ, "PTPU_RESIDENT")
    # the resident graph is matmul-only, so it is a default only with mm
    resident = (res_default and mm) if resident is None else resident
    resident = resident and environ.get("PTPU_HOST_SHIFT", "1") != "0"
    shard = _env_flag(environ, "PTPU_SHARD")
    if shard is None:
        shard = backend == "gpu" and n_local_devices > 1
    return DispatchPlan(mm=mm, resident=resident, shard=shard)


def set_platform(device: str) -> None:
    """Pin the JAX platform for ``--device`` before any backend starts."""
    if device in _PLATFORMS:
        import jax

        jax.config.update("jax_platforms", _PLATFORMS[device])


def check_platform(device: str):
    """Start the backend, verify it is the one ``--device`` asked for, and
    log what ``auto`` resolved to.  Returns the first device."""
    import jax

    try:
        devices = jax.devices()
    except RuntimeError as e:
        raise SystemExit(f"--device {device}: no usable JAX backend: {e}")
    first = devices[0]
    if device in _PLATFORMS and first.platform != device:
        raise SystemExit(
            f"--device {device}: JAX runs on {first.platform!r}"
        )
    logger.info(
        f"JAX platform {first.platform} ({first.device_kind}), "
        f"{len(devices)} device(s)"
    )
    return first


def compile_cache_dir(environ=os.environ) -> str | None:
    """The directory this program sets for JAX's persistent compile cache:
    None when ``JAX_COMPILATION_CACHE_DIR`` is set (JAX reads that variable
    itself), else ``<checkout>/.jax_cache``."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.join(CHECKOUT, ".jax_cache")


def configure_compile_cache() -> None:
    """Bucket shapes are fixed, so repeat runs skip every XLA compile."""
    cache_dir = compile_cache_dir()
    if cache_dir is None:
        return
    import jax

    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)


def visible_gpus(environ=os.environ) -> list[str]:
    """CUDA device ids this process may use, found without starting JAX
    (a JAX backend in the parent would reserve the cards its workers
    need): ``CUDA_VISIBLE_DEVICES`` when set, else ``nvidia-smi -L``."""
    vis = environ.get("CUDA_VISIBLE_DEVICES")
    if vis is not None:
        return [v.strip() for v in vis.split(",") if v.strip()]
    try:
        out = subprocess.run(
            ["nvidia-smi", "-L"], capture_output=True, text=True, timeout=60
        )
    except (OSError, subprocess.TimeoutExpired):
        return []
    if out.returncode != 0:
        return []
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("GPU ")]
    return [str(i) for i in range(len(lines))]


def assign_worker_gpus(n_workers: int, gpus: list[str]) -> list[str]:
    """One card per worker process: a JAX process reserves most of a card's
    memory when it starts, so two workers cannot share one."""
    if n_workers > len(gpus):
        raise SystemExit(
            f"--local-workers {n_workers} needs one GPU per worker, but "
            f"{len(gpus)} GPU(s) are visible"
        )
    return gpus[:n_workers]
