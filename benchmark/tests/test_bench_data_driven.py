"""The harness is driven by data, and loads nothing of JAX."""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import textwrap
import time

from benchmark import harness
from benchmark.tests.conftest import REPO


def _digest(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "benchmark")):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_cell_and_metric_are_files_only(tiny_root):
    """A cell (configuration, mix, limits) and a per-layer metric added as
    new files plus manifest entries run with no edit to a harness file."""
    before = _digest(tiny_root)
    with open(os.path.join(tiny_root, "benchmark", "metrics",
                           "passes.tiny.py"), "w") as f:
        f.write("def read(ctx):\n    return float(len(ctx.passes))\n")
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as f:
        manifest = json.load(f)
    manifest["per_layer"].append(
        {"name": "passes.tiny", "unit": "passes", "better": "higher",
         "source": "program_span", "layer": "server",
         "moves": "request_p90_ms", "workloads": ["tiny-open"]})
    with open(path, "w") as f:
        json.dump(manifest, f)
    res = harness.run(tiny_root, "tiny-open", 12345678901, 3.0, True,
                      t_start=time.monotonic(), device="cpu")
    assert res["correct"]
    assert res["metrics"]["passes.tiny"]["value"] >= 1
    after = _digest(tiny_root)
    assert {k: v for k, v in after.items() if k in before} == before


def test_new_loop_is_a_file_found_by_name(tiny_root):
    """A load loop added as benchmark/loops/<loop>.py, named by a new mix,
    serves a new cell with no edit to a harness file."""
    from benchmark.tests.conftest import TINY_TRAFFIC, add_cell, tiny_config
    before = _digest(tiny_root)
    with open(os.path.join(tiny_root, "benchmark", "loops",
                           "serve_closed_paced.py"), "w") as f:
        f.write(textwrap.dedent("""
            import time
            from benchmark.loops import serve_closed

            class Loop(serve_closed.Loop):
                def drive(self, t0, seconds):
                    time.sleep(0.05)
                    super().drive(t0, seconds)
        """))
    TINY_TRAFFIC["tiny-paced"] = dict(TINY_TRAFFIC["tiny-closed"],
                                      loop="serve_closed_paced")
    try:
        add_cell(tiny_root, "tiny-paced", tiny_config(), "tiny-paced",
                 {"latent_rel_rms": 1e-4, "audio_rel_rms": 1e-4},
                 "audio_s_per_s")
    finally:
        del TINY_TRAFFIC["tiny-paced"]
    res = harness.run(tiny_root, "tiny-paced", 12345678902, 2.0, False,
                      t_start=time.monotonic(), device="cpu")
    assert res["correct"], res["compared"]
    assert res["metrics"]["audio_s_per_s"]["value"] > 0
    after = _digest(tiny_root)
    assert {k: v for k, v in after.items() if k in before} == before


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    found_before = set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "echo_tts_tpux", sys)
    monkeypatch.setitem(sys.modules, "jaxline.x", sys)
    assert set(harness.forbidden_modules()) == found_before
    monkeypatch.setitem(sys.modules, "echo_tts_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert set(harness.forbidden_modules()) == found_before | {
        "echo_tts_tpu", "jaxlib"}


def test_harness_and_readers_load_no_jax(tiny_root):
    """In a fresh interpreter: a traced run of each tiny cell, every
    traffic loop and every per-layer reader of the manifest, and no
    module whose top-level name is jax, jaxlib, flax or echo_tts_tpu."""
    script = textwrap.dedent(f"""
        import json, sys, time
        sys.path.insert(0, {REPO!r})
        from benchmark import harness
        root = {tiny_root!r}
        for cell in ("tiny-open", "tiny-closed"):
            res = harness.run(root, cell, 2 ** 33 + 1, 2.0, True,
                              t_start=time.monotonic(), device="cpu")
            assert res["correct"], res
        with open(root + "/BENCHMARK.json") as f:
            manifest = json.load(f)
        for m in manifest["per_layer"]:
            harness.reader(root, m["name"])
        names = sorted({{m.split(".")[0] for m in sys.modules}})
        print(json.dumps(names))
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, cwd=tiny_root,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "echo_tts_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "echo_tts_tpu"}


def test_cli_without_the_program_exits_nonzero(tmp_path):
    """A checkout holding only BENCHMARK.json and benchmark/ gives no
    result line and a nonzero exit."""
    import shutil
    root = tmp_path / "bare"
    root.mkdir()
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(REPO, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "serve-bf16-open", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=root, env=env)
    assert out.returncode != 0
    assert not out.stdout.strip()
