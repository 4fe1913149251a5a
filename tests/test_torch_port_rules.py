"""Rules of the port: ``repro_torch`` and the torch examples never import
JAX or the ``repro`` package, its serve launcher runs on the CPU when
asked to (the paged layout and the prefix cache included, held to the
reference's greedy decode), and without a card it refuses to run instead
of falling back to the CPU."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__")
    for p in PKG.rglob("*.py"))


def _run(args, **kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=300, **kw)


def test_every_module_imports_without_jax_or_repro():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    res = _run(["-c", code])
    assert res.returncode == 0, res.stderr
    assert len(MODULES) >= 35


EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*PKG.rglob("*.py"), *EXAMPLES]))
def test_no_source_imports_jax_or_repro(path):
    text = (ROOT / path).read_text()
    bad = re.findall(r"^\s*(?:import jax|from jax|import repro\.|"
                     r"from repro\.|from repro import|import repro$)",
                     text, flags=re.M)
    assert not bad, bad


def test_serve_cli_runs_on_cpu():
    res = _run(["-m", "repro_torch.launch.serve", "--device", "cpu",
                "--arch", "smollm-135m", "--reduced", "--requests", "4",
                "--max-new", "8"])
    assert res.returncode == 0, res.stderr
    assert re.search(r"requests=4  generated 32 tokens in .* tok/s, slot "
                     r"utilization 100\.0%", res.stdout), res.stdout


@pytest.mark.parametrize("flag", [["--mesh", "1,1"]])
def test_serve_cli_refuses_unported_flags(flag):
    """``--mesh`` serves: one process is a one-rank group, and its summary
    line is the plain run's; a malformed spec is refused by the parser."""
    base = ["-m", "repro_torch.launch.serve", "--device", "cpu", "--arch",
            "smollm-135m", "--reduced", "--requests", "4", "--max-new", "8"]
    res, plain = _run([*base, *flag]), _run(base)
    assert res.returncode == 0, res.stderr
    assert "mesh={'data': 1, 'model': 1} params=tp layout" in res.stdout
    line = lambda out: re.sub(r"in [0-9.]+s  \([0-9.]+ tok/s", "",
                              out.strip().splitlines()[-1])
    assert line(res.stdout) == line(plain.stdout)
    assert re.search(r"requests=4  generated 32 tokens", res.stdout)
    bad = _run([*base, flag[0], flag[1].replace(",", "x")])
    assert bad.returncode == 2 and "expects 'dp,tp'" in bad.stderr


@pytest.mark.parametrize("flag", [
    ["--kv-layout", "paged"], ["--kv-quant", "--kv-layout", "paged"],
    ["--kv-layout", "paged", "--prefix-cache", "on", "--num-blocks", "14"]],
    ids=["paged", "paged-int8", "prefix-cache"])
def test_serve_cli_paged_flags_run_on_cpu_and_match_the_reference(flag,
                                                                  capsys):
    """The paged flags (refused before the paged layout was ported) run on
    the CPU: greedy, each request's tokens equal the reference's greedy
    decode on the launcher's own weights (int8 cache with ``--kv-quant``),
    and the summary line carries the pool statistics."""
    import jax
    import jax.numpy as jnp

    from _torch_parity import jax_greedy
    from repro import configs as jconfigs
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    argv = ["--device", "cpu", "--arch", "smollm-135m", "--reduced",
            "--requests", "3", "--ragged", "--prompt-len", "12",
            "--max-new", "6", "--batch", "2", "--chunk", "4",
            "--block-size", "4", "--temperature", "0", *flag]
    out = serve.main(argv)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    kv = "paged-int8" if "--kv-quant" in flag else "paged"
    assert re.search(rf"kv={kv}  requests=3  generated \d+ tokens .*"
                     r"\[paged: blocks=\d+ hwm=\d+ preempt=\d+", line), line
    assert ("[prefix-cache: hit_rate=" in line) == ("on" in flag)
    kv_quant = "--kv-quant" in flag
    tparams = T.init_params(reduced(get_config("smollm-135m")),
                            torch.Generator().manual_seed(0))
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tparams)
    jcfg = jconfigs.reduced(jconfigs.get_config("smollm-135m")).replace(
        use_pallas=False, kv_quant=kv_quant)
    for r in out["requests"]:
        assert out["completions"][r.uid] == jax_greedy(
            jcfg, jparams, r.tokens, r.max_new_tokens)


def test_serve_cli_without_a_card_refuses_to_run():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    res = _run(["-m", "repro_torch.launch.serve", "--arch", "smollm-135m",
                "--reduced", "--requests", "2", "--max-new", "2"])
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr


def test_entry_points_default_to_cuda():
    from repro_torch import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(None)
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_chip_smoke_needs_a_card_and_the_port(tmp_path):
    """Alone in a directory, or without CUDA, the chip script exits
    non-zero and prints no result line."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    res = subprocess.run([sys.executable, str(alone)], capture_output=True,
                         text=True, cwd=tmp_path, timeout=300,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
