"""What the harness may import, and what it finds by name."""
import ast
import json
from pathlib import Path

import numpy as np
import pytest

from hbm_bench import loadgen, metrics

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    """Top-level names of every module a source file imports."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    # compared whole: repro_torch is the port, repro the JAX package
    assert not set(_imports(path)) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((HERE / "reference").rglob("*.py")):
        assert "repro_torch" not in set(_imports(path)), path


def test_benchmark_names_resolve_to_files():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for conf in spec["configs"]:
        cfg = json.loads((ROOT / conf["file"]).read_text())
        assert cfg["name"] == conf["name"]
        assert (HERE / f"{cfg['system']}.py").exists()
        assert (HERE / "reference" / f"{cfg['reference']}.py").exists()
    for cell in spec["workloads"]:
        loadgen.load_mix(cell["traffic"])
    for group in ("end_to_end", "per_layer"):
        for m in spec[group]:
            assert metrics.reader_file(m["name"]).exists(), m["name"]


def test_a_new_traffic_file_is_found_by_name(tmp_path):
    raw = json.loads((loadgen.TRAFFIC_DIR / "reasoning-closed8.json")
                     .read_text())
    raw.update(clients=3, prompt_len={"median": 6, "sigma": 0.5, "min": 4,
                                      "max": 9}, strata=5)
    (tmp_path / "tiny-new-mix.json").write_text(json.dumps(raw))
    mix = loadgen.load_mix("tiny-new-mix", directory=tmp_path)
    assert mix.clients == 3 and mix.prompt_len.max == 9
    t = loadgen.Traffic(mix, 7, 100)
    assert all(4 <= t.lengths(i)[0] <= 9 for i in range(3, 20))


@pytest.mark.parametrize("name", sorted(
    p.stem for p in loadgen.TRAFFIC_DIR.glob("*.json")))
def test_every_seed_serves_the_same_sizes_in_its_own_order(name):
    mix = loadgen.load_mix(name)
    k, c, n = mix.strata, mix.clients, mix.clients + 8 * mix.strata
    a = loadgen.Traffic(mix, 2**31 + 17, 64000)
    b = loadgen.Traffic(mix, 2**31 + 18, 64000)
    la, lb = [a.lengths(i) for i in range(n)], [b.lengths(i) for i in range(n)]
    # each client's first request: a spread share of the medians, the
    # same for every seed
    assert la[:c] == lb[:c]
    assert [o for _, o in la[:c]] == sorted(o for _, o in la[:c])
    assert la[c:] != lb[c:]
    for block in range(8):
        got = la[c + block * k:c + (block + 1) * k]
        assert sorted(p for p, _ in got) == sorted(
            p for p, _ in lb[c + block * k:c + (block + 1) * k])
        # one prompt from each band of the distribution, tail included
        want = sorted(mix.prompt_len.at((j + 0.5) / k) for j in range(k))
        assert sorted(p for p, _ in got) == want
    for p, o in la:
        assert p + o <= mix.max_len and p >= 1 and o >= 2
    again = loadgen.Traffic(mix, 2**31 + 17, 64000)
    ra = [a.next() for _ in range(4)]
    rb = [again.next() for _ in range(4)]
    other = [b.next() for _ in range(4)]
    for x, y, z in zip(ra, rb, other):
        assert np.array_equal(x.prompt, y.prompt)
        assert not np.array_equal(x.prompt, z.prompt)
    assert [len(r.prompt) for r in ra] == [p for p, _ in la[:4]]
