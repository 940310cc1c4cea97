"""The port imports torch and never JAX, gmix_tpu or the repository's
tools/ (the ensemble variants and the dump generator are the port's own
copies, variants.py and preprocess/wiki_corpus.py, and sweeps.py imports
neither tools/ nor bench.py): a fresh
interpreter imports every module under gmix_tpu_torch/ and must end with
none of them loaded."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = """
import importlib, pkgutil, sys
import gmix_tpu_torch
names = ["gmix_tpu_torch"] + [m.name for m in pkgutil.walk_packages(gmix_tpu_torch.__path__, "gmix_tpu_torch.")]
for name in names:
    importlib.import_module(name)
# nor the repository's tools (which import gmix_tpu), nor its bench.py
tools = {n[:-3] for n in __import__("os").listdir("tools") if n.endswith(".py")} | {"bench", "tools"}
bad = sorted(m for m in sys.modules if m.split(".")[0] in {"jax", "jaxlib", "gmix_tpu"} | tools)
# generation, checkpoints, stream sharding over devices and processes, the
# command line, the preprocessors and the bench among them
missing = {"gmix_tpu_torch.utils.serialization", "gmix_tpu_torch.parallel.mesh", "gmix_tpu_torch.cli",
           "gmix_tpu_torch.preprocess.dictionary", "gmix_tpu_torch.preprocess.wiki",
           "gmix_tpu_torch.parallel.distributed", "gmix_tpu_torch.bench", "gmix_tpu_torch.variants",
           "gmix_tpu_torch.sweeps", "gmix_tpu_torch.preprocess.wiki_corpus"} - set(names)
print(len(names), "modules")
print("FORBIDDEN", bad, "MISSING", sorted(missing))
sys.exit(1 if bad or missing or len(names) < 28 else 0)
"""


def test_no_module_of_the_port_imports_jax_or_gmix_tpu():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "FORBIDDEN [] MISSING []" in out.stdout
