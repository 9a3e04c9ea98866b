"""What the harness and the reference load, by whole top-level module
name, in fresh processes."""
from __future__ import annotations

import json
import subprocess
import sys

from conftest import BENCH, ROOT

PROBE = """
import json, sys
sys.path[:0] = {paths!r}
{imports}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def loaded(imports: str) -> set:
    code = PROBE.format(paths=[str(ROOT), str(BENCH)], imports=imports)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=BENCH)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax_nor_the_jax_package():
    mods = loaded("import run, programs, control, devtrace, check, work")
    assert "mvae_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "mvae_tpu"}


def test_reference_loads_nothing_of_the_program():
    mods = loaded("import reference.vae, reference.binarize, check, "
                  "generate, work")
    assert not mods & {"jax", "jaxlib", "flax", "mvae_tpu", "mvae_torch"}
