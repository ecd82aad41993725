"""A later change adds a cell by adding files: a configuration, a
traffic mix, a limits file and a per-layer metric, plus entries in
``BENCHMARK.json``.  In a copy of the benchmark with exactly that added,
the harness finds and runs the new cell (on the CPU, at a tiny size) with
no existing file of ``portbench/`` edited."""

import filecmp
import json
import os
import shutil
import subprocess
import sys

from portbench.tests.tiny import BENCH, ROOT, TINY

SRC = os.path.join(ROOT, "portbench")


def test_new_cell_from_new_files_only(tmp_path):
    dst = tmp_path / "portbench"
    shutil.copytree(SRC, dst, ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.load(open(BENCH))
    cfg = json.load(open(dst / "configs" / "ldpc_96.3.963.json"))
    cfg.update(TINY["ldpc"])
    (dst / "configs" / "ldpc_small.json").write_text(json.dumps(cfg))
    mix = json.load(open(dst / "traffic" / "train_ldpc.b4096.json"))
    mix.update(batch=8, chunk=2, pool_batches=3)
    (dst / "traffic" / "train_ldpc.b8.json").write_text(json.dumps(mix))
    shutil.copy(dst / "limits" / "ldpc_train.b4096.json",
                dst / "limits" / "ldpc_small.b8.json")
    (dst / "metrics" / "window_steps.train.py").write_text(
        'LAYER = "entry"\nUNIT = "steps"\nMOVES = "train_samples_per_s"\n'
        'SOURCE = "host_clock"\n\n\ndef read(ctx):\n'
        '    return ctx.window["steps"]\n')
    bench["configs"].append({"name": "ldpc_small", "source": "x",
                             "file": "portbench/configs/ldpc_small.json",
                             "reduced": ["dims"], "why": "a test"})
    bench["workloads"].append({"name": "ldpc_small.b8", "config": "ldpc_small",
                               "traffic": "train_ldpc.b8", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_samples_per_s":
            m["workloads"].append("ldpc_small.b8")
    bench["per_layer"].append({"name": "window_steps.train", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "entry",
                               "moves": "train_samples_per_s",
                               "workloads": ["ldpc_small.b8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    code = ("import json; from portbench.registry import Cell; "
            "from portbench import harness; c = Cell('ldpc_small.b8'); "
            "print(json.dumps([harness.execute(c, 5, 0.1, t, device='cpu', "
            "n_workers=1) for t in (0, 1)]))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    plain, traced = json.loads(res.stdout.strip().splitlines()[-1])
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert traced["metrics"]["window_steps.train"]["value"] >= 1
    # every file the copy shares with the benchmark is unchanged
    cmp = filecmp.dircmp(SRC, dst, ignore=["__pycache__"])

    def changed(d):
        return d.diff_files + [x for s in d.subdirs.values()
                               for x in changed(s)]

    assert changed(cmp) == []
