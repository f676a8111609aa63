"""The port's batch runners (``python -m gftorf_tpu_torch.run_optimize``,
``.run_render``) against the root ``run_optimize.py`` and
``run_render.py``.

``subprocess.run`` is replaced by a recorder in both, so nothing trains.
For every scene of both families, and for ``--scenes``, ``--family``,
``--data_root``, ``--no_render``, ``--output_root``, ``--iteration`` and
``--traj``, the lists of commands must be equal once ``train.py``,
``render.py`` and ``render_traj.py`` map to the port's ``-m`` entries,
``--platform`` to ``--device``, and the output directories' timestamps
are masked. Each port command must parse with its CLI's own parser.
"""

import os
import re
import runpy
import subprocess
import sys

import pytest

from gftorf_tpu_torch import run_optimize, run_render
from gftorf_tpu_torch.render.__main__ import build_parser as render_parser
from gftorf_tpu_torch.render_traj import build_parser as traj_parser
from gftorf_tpu_torch.train.__main__ import build_parser as train_parser

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENTRIES = {"train.py": "gftorf_tpu_torch.train",
           "render.py": "gftorf_tpu_torch.render",
           "render_traj.py": "gftorf_tpu_torch.render_traj"}
PARSERS = {"gftorf_tpu_torch.train": train_parser,
           "gftorf_tpu_torch.render": render_parser,
           "gftorf_tpu_torch.render_traj": traj_parser}
STAMP = re.compile(r"_\d{8}_\d{6}$")


@pytest.fixture
def recorded(monkeypatch):
    calls = []

    def fake_run(cmd, check=False, **kw):
        assert check
        calls.append([STAMP.sub("_STAMP", str(t)) for t in cmd])
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(subprocess, "run", fake_run)
    return calls


def root_script(name, argv, monkeypatch, calls):
    """The root script run as ``python name argv...``; its commands."""
    del calls[:]
    monkeypatch.setattr(sys, "argv", [name] + argv)
    runpy.run_path(os.path.join(ROOT, name), run_name="__main__")
    return list(calls)


def port_runner(module, argv, calls):
    del calls[:]
    module.main(argv)
    return list(calls)


def to_port(cmd):
    out = [cmd[0]]
    for tok in cmd[1:]:
        if tok in ENTRIES:
            out += ["-m", ENTRIES[tok]]
        else:
            out.append("--device" if tok == "--platform" else tok)
    return out


def assert_port_commands(root_cmds, port_cmds):
    assert port_cmds == [to_port(c) for c in root_cmds]
    for cmd in port_cmds:
        assert cmd[:2] == [sys.executable, "-m"]
        PARSERS[cmd[2]]().parse_args(cmd[3:])


OPTIMIZE_CASES = {
    "all": [],
    "ftorf": ["--family", "ftorf"],
    "torf_no_render": ["--family", "torf", "--no_render"],
    "scenes": ["--scenes", "cupboard", "target1", "jacks1",
               "--data_root", "/data/gftorf"],
    "scenes_torf_only": ["--family", "torf", "--scenes", "phonebooth", "fan"],
    "unknown_scene": ["--scenes", "nowhere"],
}


@pytest.mark.parametrize("argv", list(OPTIMIZE_CASES.values()),
                         ids=list(OPTIMIZE_CASES))
def test_run_optimize_commands_match_root(recorded, monkeypatch, argv):
    want = root_script("run_optimize.py", argv, monkeypatch, recorded)
    got = port_runner(run_optimize, argv, recorded)
    assert_port_commands(want, got)


def test_run_optimize_covers_every_scene(recorded, monkeypatch):
    cmds = port_runner(run_optimize, [], recorded)
    trained = [c[c.index("--source_path") + 1].split("/")[-1]
               for c in cmds if c[2] == "gftorf_tpu_torch.train"]
    want = ([s[1] for s in run_optimize.SCENES_FTORF]
            + [s[0] for s in run_optimize.SCENES_TORF])
    assert trained == want and len(want) == 17
    assert sum(c[2] == "gftorf_tpu_torch.render" for c in cmds) == 17
    root = runpy.run_path(os.path.join(ROOT, "run_optimize.py"))
    assert run_optimize.SCENES_FTORF == root["SCENES_FTORF"]
    assert run_optimize.SCENES_TORF == root["SCENES_TORF"]
    cmds = port_runner(run_optimize, ["--no_render", "--scenes", "fan"],
                       recorded)
    assert len(cmds) == 1 and "data/ftorf_real_scenes/fan" in cmds[0]


@pytest.fixture
def output_root(tmp_path):
    root = tmp_path / "output"
    for name in ("cupboard_20250101_000000", "fan_20250101_000000",
                 "target1_20250102_000000"):
        (root / name).mkdir(parents=True)
        (root / name / "cfg_args_full.json").write_text("{}")
    (root / "not_a_model").mkdir()
    (root / "stray.txt").write_text("")
    return str(root)


RENDER_CASES = {
    "all": [],
    "traj": ["--traj"],
    "scenes_iteration": ["--scenes", "fan", "target", "--iteration", "7000"],
    "device": ["--traj", "--platform", "cpu"],
}


@pytest.mark.parametrize("argv", list(RENDER_CASES.values()),
                         ids=list(RENDER_CASES))
def test_run_render_commands_match_root(recorded, monkeypatch, output_root,
                                        argv):
    argv = ["--output_root", output_root] + argv
    want = root_script("run_render.py", argv, monkeypatch, recorded)
    got = port_runner(run_render, [{"--platform": "--device"}.get(a, a)
                                   for a in argv], recorded)
    assert_port_commands(want, got)
    assert all("not_a_model" not in " ".join(c) for c in got)
    assert len(got) >= 2
