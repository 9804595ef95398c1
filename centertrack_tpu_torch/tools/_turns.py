"""What the tools that time two checkouts of the port on one card share:
the port's package of the checkout a tool is pointed at (``--root``),
this checkout's ``chip_smoke.py`` as a module over it, and the runs in
turns (parent, change, change, parent; one process each, so that each
builds and loads its own kernels)."""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ORDER = ("parent", "change", "change", "parent")


def use_root(root: str) -> None:
    """Make ``import centertrack_tpu_torch`` load the package of the
    checkout at ``root``, also where this checkout's was imported first
    (as ``python3 -m`` does)."""
    sys.path.insert(0, os.path.abspath(root))
    for name in [m for m in sys.modules
                 if m.split(".")[0] == "centertrack_tpu_torch"]:
        del sys.modules[name]


def smoke():
    """This checkout's chip_smoke.py as a module. Import the port's
    package first: the smoke then uses the package already loaded,
    whichever checkout it came from."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run(tool: str, root: str, *args: str) -> list:
    """The JSON objects that ``python3 -m centertrack_tpu_torch.tools.<tool>
    --root <root> <args>`` prints, run from this checkout in a process of
    its own; exits with its output where it fails."""
    out = subprocess.run([sys.executable, "-m",
                          "centertrack_tpu_torch.tools." + tool,
                          "--root", root, *args],
                         capture_output=True, text=True, cwd=ROOT)
    if out.returncode != 0:
        raise SystemExit(f"{tool} on {root} failed:\n{out.stdout}"
                         f"{out.stderr}")
    return [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]


def in_turns(measure, parent: str, change: str) -> list:
    """[(side, measure(its checkout))] for the sides of ORDER, in turn."""
    return [(side, measure(parent if side == "parent" else change))
            for side in ORDER]
