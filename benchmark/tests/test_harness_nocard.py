"""A run without a card fails and prints no result; so does a checkout
that holds only the benchmark's files."""

import json
import os
import shutil
import subprocess
import sys

from benchmark.harness.common import BENCH, ROOT


def _run(cwd, env_extra):
    env = dict(os.environ, **env_extra)
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "pipeline_h64.extractor_train",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def _no_result(out):
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        try:
            assert "correct" not in json.loads(line)
        except ValueError:
            pass


def test_no_card_no_result():
    _no_result(_run(ROOT, {"CUDA_VISIBLE_DEVICES": ""}))


def test_benchmark_files_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    _no_result(_run(tmp_path, {}))
