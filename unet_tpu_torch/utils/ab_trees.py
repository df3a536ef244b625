"""Kernel times of two source trees on one card, measured in turns.

    python -m unet_tpu_torch.utils.ab_trees --trees OLD . . OLD \
        --checks check_groupnorm check_groupnorm_bwd [--out FILE]

OLD is another checkout of this repository (for example the parent commit,
unpacked with `git archive` into a directory that `.gitignore` lists).
Each turn starts one child process in the tree it names, which imports that
tree's `chip_smoke.py` (so its package and its kernels, built from its own
sources), sets the shape lists that the checks read (`GN_SHAPES`,
`GN_BWD_SHAPES`, `TP_GN_CASES`, `ATTN_SHAPES`, `ATTN_BWD_SHAPES`,
`CONV_SHAPES`, `SPLIT_SHAPES`, `ATTN_HEAD_SHAPES`, `ATTN_HEAD_BWD_SHAPES`,
`ATTN_HEAD_TIMED`) to those of the current directory's `chip_smoke.py`,
and runs the named check functions.  A check returns a
list of cases, or one list per kernel (`check_split_kernels`: `{kernel:
cases}`); only the timed cases, those with `kernel_graph_ms`, are compared.
`check_conv` times both types at the shape `CONV_HEADLINE` names, so for it
the child names each shape in turn and keeps both of its cases.  The
attention checks take only the head sizes that `ATTN_HEAD_TIMED` times
(`ATTN_SHAPES` and `ATTN_BWD_SHAPES` are all timed).
So both trees are timed at the same shapes, on the same card, in the
order given (old, new, new, old evens out drift).  Prints one JSON object
per turn, then one summary: per case the fastest device-alone time
(`kernel_graph_ms`, a CUDA graph of 20 calls) of each tree over its turns,
and their ratio.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import subprocess
import sys

SHAPE_LISTS = ("GN_SHAPES", "GN_BWD_SHAPES", "TP_GN_CASES", "ATTN_SHAPES",
               "ATTN_BWD_SHAPES", "CONV_SHAPES", "SPLIT_SHAPES",
               "ATTN_HEAD_SHAPES", "ATTN_HEAD_BWD_SHAPES", "ATTN_HEAD_TIMED")

_CHILD = r"""
import json, sys, torch
import chip_smoke as c
lists, checks = json.loads(sys.argv[1]), sys.argv[2:]
for name, value in lists.items():
    setattr(c, name, {k: [tuple(s) for s in v] for k, v in value.items()}
            if isinstance(value, dict) else [tuple(s) for s in value])
c.functional.set_f32_precision("highest")
c._build.load()
gen = torch.Generator(device=c.DEV).manual_seed(0)


def conv_cases():
    cases = []
    for shape in lists["CONV_SHAPES"]:
        c.CONV_SHAPES = [tuple(shape)]
        c.CONV_HEADLINE = dict(shape=list(shape), dtype="torch.float32")
        cases += [k for k in c.check_conv(gen) if "kernel_graph_ms" in k]
    return cases


out = {name: conv_cases() if name == "check_conv" else getattr(c, name)(gen)
       for name in checks}
print(json.dumps(out))
"""


def shape_lists(path: str) -> dict:
    """The shape lists assigned at the top level of a chip_smoke.py, read
    without importing it."""
    lists = {}
    for node in ast.parse(open(path).read()).body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) in SHAPE_LISTS):
            lists[node.targets[0].id] = ast.literal_eval(node.value)
    return lists


def timed_heads(lists: dict) -> dict:
    """The lists with the attention head sizes cut to those that
    `ATTN_HEAD_TIMED` times: only timed cases are compared."""
    timed = lists["ATTN_HEAD_TIMED"]
    return dict(lists, ATTN_HEAD_BWD_SHAPES=[], ATTN_HEAD_SHAPES=sorted(
        set(map(tuple, timed["fwd"])) | set(map(tuple, timed["bwd"]))))


def case_key(check: str, kernel: str, case: dict) -> str:
    return " ".join(part for part in (check, kernel, str(case["shape"]),
                                      case["dtype"], case.get("act", ""))
                    if part)


def timed_cases(check: str, cases):
    """(key, case) of each timed case of a check's result: a list of cases,
    or {kernel: cases}."""
    groups = cases.items() if isinstance(cases, dict) else [("", cases)]
    for kernel, group in groups:
        for case in group:
            if "kernel_graph_ms" in case:
                yield case_key(check, kernel, case), case


def run_turn(tree: str, lists: dict, checks) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, json.dumps(lists), *checks],
        cwd=tree, env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"turn in {tree} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def summarise(turns) -> dict:
    """Per case: each tree's fastest device-alone time and the ratio of the
    last tree named to the first."""
    best = {}
    for tree, result in turns:
        for check, cases in result.items():
            for key, case in timed_cases(check, cases):
                entry = best.setdefault(key, {})
                ms = case["kernel_graph_ms"]
                entry[tree] = min(entry.get(tree, ms), ms)
    trees = list(dict.fromkeys(tree for tree, _ in turns))
    first, last = trees[0], trees[-1]
    return {key: dict(ms, ratio=ms[last] / ms[first])
            for key, ms in best.items() if first in ms and last in ms}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trees", nargs="+", required=True,
                        help="the trees, in the order of the turns")
    parser.add_argument("--checks", nargs="+", required=True,
                        help="chip_smoke.py functions that return cases")
    parser.add_argument("--out", help="also write every line to this file")
    args = parser.parse_args(argv)
    lists = timed_heads(shape_lists("chip_smoke.py"))
    lines, turns = [], []
    for i, tree in enumerate(args.trees):
        result = run_turn(tree, lists, args.checks)
        turns.append((tree, result))
        lines.append(json.dumps({"turn": i, "tree": tree, **result}))
        print(lines[-1], flush=True)
    lines.append(json.dumps({"summary": summarise(turns)}))
    print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
