"""Nothing the benchmark runs loads JAX or the JAX package, and the
references load nothing of the port: each checked in a fresh process,
by whole top-level module names (``repro_torch`` is not ``repro``)."""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

HARNESS = """
import json, sys
sys.path[:0] = [{root!r} + "/src", {root!r}]
from pathlib import Path
from portbench import control, devtrace, harness, inputs, readers
from portbench import traffic
for kind in ("metrics", "reference", "work"):
    for p in sorted((Path({root!r}) / "portbench" / kind).glob("*.py")):
        harness.load_file(kind, p.stem)
for p in sorted((Path({root!r}) / "portbench" / "configs").glob("*.json")):
    cfg = harness.load_config(p.stem)
    harness.build_graph(cfg)
for p in sorted(traffic.MIXES.glob("*.json")):
    traffic.load_mix(p.stem)
# what the drivers import at set-up
import repro_torch.core.mari, repro_torch.launch.steps, repro_torch.serve
import repro_torch.kernels.build
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCES = """
import json, sys
sys.path[:0] = [{root!r}]
from pathlib import Path
from portbench import harness
for p in sorted((Path({root!r}) / "portbench" / "reference").glob("*.py")):
    harness.load_file("reference", p.stem)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code: str) -> set[str]:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code.format(root=ROOT)],
                         capture_output=True, text=True, env=env,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax_nor_the_jax_package():
    mods = _top_level(HARNESS)
    assert "repro_torch" in mods and "portbench" in mods
    assert not mods & {"jax", "jaxlib", "flax", "repro"}


def test_references_load_nothing_of_the_port():
    mods = _top_level(REFERENCES)
    assert "torch" in mods
    assert not mods & {"repro_torch", "jax", "jaxlib", "flax", "repro"}
