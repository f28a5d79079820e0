"""The port's examples must keep working (they are documentation):
``tests/test_example.py`` (2 cases) over ``examples/torch_*.py``, on the
CPU (``VROD_PLATFORM=cpu``), plus the replication example, and the port's
quickstart against the JAX package's, line for line.

The two quickstarts print every name and score to 3 decimals, and print
the same lines: the scores are cosines of the same hashed embeddings,
which differ between the packages by float32 rounding far below 5e-4.
"""

import runpy
import sys
from pathlib import Path

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def run_example(name, capsys):
    runpy.run_path(str(EXAMPLES / name), run_name="__main__")
    return capsys.readouterr().out


def test_quickstart_runs(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    out = run_example("torch_quickstart.py", capsys)
    assert "Inserted 18 records" in out
    assert "recall check: 1.0" in out


def test_serving_example_runs(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("VROD_EXAMPLE_SECONDS", "1.0")
    out = run_example("torch_serving.py", capsys)
    assert "served" in out and "packed batches" in out


def test_replication_example_runs(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    out = run_example("torch_replication.py", capsys)
    assert "read-your-writes through the pool: Hit(501, 1.000000, " \
        "'fresh-write')" in out
    assert "replica promoted; first write on the new primary: id 502" in out
    assert out.rstrip().endswith("done")


def test_quickstarts_print_the_same_lines(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    port = run_example("torch_quickstart.py", capsys).splitlines()
    jax_lines = run_example("quickstart.py", capsys).splitlines()
    assert len(port) == 6
    assert port == jax_lines
