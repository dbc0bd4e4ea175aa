import io
import subprocess
import sys

from mini_parallel import device
from mini_parallel.io import fastq
from mini_parallel.tools import linecount


def test_device_enumeration():
    devs = device.get_devices()
    assert len(devs) == 8  # virtual CPU mesh from conftest
    assert all(d.platform == "cpu" for d in devs)


def test_accelerator_probe_cpu_mesh():
    assert device.is_accelerator_available() is False  # cpu-only in tests


def test_enable_compile_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    assert device.enable_compile_cache() == str(tmp_path / "cache")
    assert (tmp_path / "cache").is_dir()


def test_compile_cache_dir_follows_env(tmp_path):
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}
    assert device.compile_cache_dir(env) == str(tmp_path)


def test_compile_cache_dir_defaults_into_checkout():
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(device.__file__)))
    assert device.compile_cache_dir({}) == os.path.join(root, ".jax_cache")
    assert device.compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": ""}) == \
        os.path.join(root, ".jax_cache")


def test_linecount_tool(tmp_path, rng, capsys):
    from tests.conftest import random_dna

    path = str(tmp_path / "x.fastq.gz")
    fastq.write_fastq(path, [random_dna(rng, 10)] * 7)
    assert linecount.main([path]) == 0
    assert "28 lines" in capsys.readouterr().out


def test_linecount_missing_file(capsys):
    assert linecount.main(["/nonexistent"]) == 1


def test_linecount_no_args(capsys):
    assert linecount.main([]) == 2


def test_stdin_linecount_subprocess():
    out = subprocess.run(
        [sys.executable, "-m", "mini_parallel.tools.stdin_linecount"],
        input=b"a\nb\nc\n", capture_output=True, cwd="/root/repo",
    )
    assert out.stdout.strip() == b"3"


def test_kernel_check_refuses_cpu(capsys):
    from mini_parallel.tools import kernel_check

    assert kernel_check.main([]) == 1
    assert "needs a GPU" in capsys.readouterr().out


def test_kernel_check_tiny_on_cpu(capsys):
    """The parity gate's every check, at its tiny CPU sizes."""
    from mini_parallel.tools import kernel_check

    assert kernel_check.main(["--allow-cpu"]) == 0
    out = capsys.readouterr().out
    assert f"{len(kernel_check.CHECKS)}/{len(kernel_check.CHECKS)}" in out
    assert "GCUPS" not in out  # rates are device numbers only


def _run_chip_smoke(cwd):
    import os

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_refuses_cpu():
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = _run_chip_smoke(root)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "needs a GPU" in out.stderr


def test_chip_smoke_alone_refuses(tmp_path):
    import os
    import shutil

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    shutil.copy(os.path.join(root, "chip_smoke.py"), tmp_path)
    out = _run_chip_smoke(str(tmp_path))
    assert out.returncode != 0 and '"ok"' not in out.stdout
