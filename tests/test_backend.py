"""Backend selection (portello_tpu/backend.py) and the CLI's device
handling: dispatch plans per backend, the compile-cache location, one GPU
per worker process, and failures that must not fall back silently."""

import os
import subprocess
import sys

import numpy as np
import pytest

from portello_tpu import backend
from portello_tpu.backend import DispatchPlan, select_dispatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "name,n_dev,want",
    [
        ("cpu", 1, DispatchPlan(mm=False, resident=False, shard=False)),
        ("cpu", 8, DispatchPlan(mm=False, resident=False, shard=False)),
        ("gpu", 1, DispatchPlan(mm=False, resident=False, shard=False)),
        ("gpu", 4, DispatchPlan(mm=False, resident=False, shard=True)),
    ],
)
def test_select_dispatch_defaults(name, n_dev, want):
    assert select_dispatch(name, n_dev, environ={}) == want


@pytest.mark.parametrize(
    "env,want",
    [
        ({"PTPU_MM": "1"}, DispatchPlan(mm=True, resident=False, shard=False)),
        ({"PTPU_RESIDENT": "1"},
         DispatchPlan(mm=False, resident=True, shard=False)),
        ({"PTPU_SHARD": "1"}, DispatchPlan(mm=False, resident=False, shard=True)),
        # resident slots need host-shift routing
        ({"PTPU_RESIDENT": "1", "PTPU_HOST_SHIFT": "0"},
         DispatchPlan(mm=False, resident=False, shard=False)),
    ],
)
def test_select_dispatch_env_overrides_cpu(env, want):
    assert select_dispatch("cpu", 8, environ=env) == want


@pytest.mark.parametrize(
    "env,want",
    [
        ({"PTPU_MM": "1"}, DispatchPlan(mm=True, resident=False, shard=False)),
        ({"PTPU_MM": "1", "PTPU_RESIDENT": "1"},
         DispatchPlan(mm=True, resident=True, shard=False)),
        ({"PTPU_SHARD": "0"}, DispatchPlan(mm=False, resident=False,
                                           shard=False)),
    ],
)
def test_select_dispatch_env_overrides_gpu(env, want):
    """The formulations chip_smoke.py compares on the card are each one
    override away from the GPU default."""
    n_dev = 4 if "PTPU_SHARD" in env else 1
    assert select_dispatch("gpu", n_dev, environ=env) == want


@pytest.mark.parametrize("name", ["rocm", "metal", ""])
def test_select_dispatch_unknown_backend(name):
    with pytest.raises(ValueError, match="no dispatch plan"):
        select_dispatch(name, 1, environ={})


def test_compile_cache_honours_env():
    assert backend.compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/somewhere"}
    ) is None


def test_compile_cache_defaults_to_checkout():
    assert backend.compile_cache_dir({}) == os.path.join(REPO, ".jax_cache")


def test_configure_compile_cache_sets_nothing_under_env(monkeypatch):
    import jax

    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    backend.configure_compile_cache()
    assert calls == []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    backend.configure_compile_cache()
    assert ("jax_compilation_cache_dir",
            os.path.join(REPO, ".jax_cache")) in calls


def test_visible_gpus_from_cuda_visible_devices():
    assert backend.visible_gpus({"CUDA_VISIBLE_DEVICES": "2, 5,7"}) == [
        "2", "5", "7"
    ]
    assert backend.visible_gpus({"CUDA_VISIBLE_DEVICES": ""}) == []


def test_assign_worker_gpus_one_card_each():
    assert backend.assign_worker_gpus(2, ["3", "1", "0"]) == ["3", "1"]
    assert backend.assign_worker_gpus(4, ["0", "1", "2", "3"]) == [
        "0", "1", "2", "3"
    ]


def test_assign_worker_gpus_refuses_too_many():
    with pytest.raises(SystemExit, match="needs one GPU per worker"):
        backend.assign_worker_gpus(3, ["0", "1"])


@pytest.mark.parametrize(
    "device,visible,want",
    [
        ("cpu", "0,1", None),
        ("host", "0,1", None),
        ("auto", "", None),
        ("auto", "4,5", ["4", "5"]),
        ("gpu", "6,7,8", ["6", "7"]),
    ],
)
def test_worker_cards(monkeypatch, device, visible, want):
    from portello_tpu.main import _worker_cards

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    assert _worker_cards(device, 2) == want


def test_worker_cards_gpu_without_cards(monkeypatch):
    from portello_tpu.main import _worker_cards

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    with pytest.raises(SystemExit, match="0 GPU"):
        _worker_cards("gpu", 2)


@pytest.fixture(scope="module")
def small_scenario(tmp_path_factory):
    from portello_tpu.testutil.simulate import make_scenario

    root = tmp_path_factory.mktemp("backend_scn")
    make_scenario(str(root), rng=np.random.default_rng(5),
                  n_reads_per_contig=4)
    return root


def _cli_args(root, device):
    return [
        "--assembly-to-ref", str(root / "asm_to_ref.bam"),
        "--read-to-assembly", str(root / "read_to_asm.bam"),
        "--ref", str(root / "ref.fa"),
        "--remapped-read-output", str(root / f"r_{device}.bam"),
        "--unassembled-read-output", str(root / f"u_{device}.bam"),
        "--device", device,
    ]


def test_device_gpu_without_gpu_exits_nonzero(small_scenario):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("CUDA_VISIBLE_DEVICES", None)
    proc = subprocess.run(
        [sys.executable, "-m", "portello_tpu.main",
         *_cli_args(small_scenario, "gpu")],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO,
    )
    assert proc.returncode != 0
    assert "--device gpu" in proc.stderr


def test_device_choices(small_scenario, capsys):
    from portello_tpu.cli import build_parser
    from portello_tpu.main import main

    (device,) = [a for a in build_parser()._actions if a.dest == "device"]
    assert device.choices == ["auto", "gpu", "cpu", "host"]
    with pytest.raises(SystemExit) as e:
        main(_cli_args(small_scenario, "cuda"))
    assert e.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


def test_make_engine_propagates_engine_failure(small_scenario, monkeypatch):
    """A device engine that cannot start fails the run instead of quietly
    handing the work to the host path."""
    from portello_tpu.cli import parse_settings
    from portello_tpu.main import make_engine
    from portello_tpu.models import pipeline_model

    def broken(*a, **k):
        raise RuntimeError("engine exploded")

    monkeypatch.setattr(pipeline_model, "DeviceEngine", broken)
    settings = parse_settings(_cli_args(small_scenario, "cpu"))
    with pytest.raises(RuntimeError, match="engine exploded"):
        make_engine(settings, [], None, [])
    settings = parse_settings(_cli_args(small_scenario, "host"))
    assert make_engine(settings, [], None, []) is None


def test_cli_engine_failure_exits_nonzero(small_scenario, monkeypatch):
    from portello_tpu.main import main
    from portello_tpu.models import pipeline_model

    def broken(*a, **k):
        raise RuntimeError("engine exploded")

    monkeypatch.setattr(pipeline_model, "DeviceEngine", broken)
    with pytest.raises(SystemExit) as e:
        main(_cli_args(small_scenario, "cpu"))
    assert e.value.code != 0
    assert not (small_scenario / "r_cpu.bam").exists()
