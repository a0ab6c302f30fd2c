"""The port's chaos tool (``unicore_tpu_torch/tools/chaos.py``) on the
CPU (``--cpu``): its legs drive ``python -m unicore_tpu_torch.cli.train``
in child processes on the JAX tool's tiny BERT and hold every record of
a killed-and-resumed run to an uninterrupted oracle's, bit for bit.

- a SIGKILL-resume leg (8 updates, a save every 2, the kill at a seeded
  step after the first save);
- an inject leg (``--inject spike:5``: dispatch 5 skipped in both runs,
  every later loss finite and equal);
- a data leg (``--data corrupt:2``: exactly the 2 torn records skipped
  in epoch 1, the skip log equal to the seeded oracle and carried across
  a SIGKILL-resume);
and the tool's pieces against the JAX tool's: the corpus bytes, the
trajectory comparison and the skip oracle.
"""

import importlib.util
import json
import os

from unicore_tpu_torch.tools import chaos

REPO = chaos.REPO


def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "unicore_chaos", os.path.join(REPO, "tools", "unicore_chaos.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _leg(tmp_path, monkeypatch, *argv):
    # the child runs on one thread each: the suite's workers share the
    # cores
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = str(tmp_path / "report.json")
    rc = chaos.main(["--cpu", "--workdir", str(tmp_path / "work"),
                     "--json", out, *argv])
    with open(out) as f:
        return rc, json.load(f)


def test_sigkill_resume_leg_is_bit_exact(tmp_path, monkeypatch):
    rc, report = _leg(tmp_path, monkeypatch, "--max-update", "8",
                      "--save-interval-updates", "2")
    assert rc == 0 and report["bit_exact"]
    assert report["kills"][0]["kill_at"] >= 3
    # every dispatch of the killed run and of its resume (which re-does
    # the updates after its checkpoint) held to the oracle's
    assert report["records_compared"] >= 8


def test_inject_spike_leg_skips_in_both_runs(tmp_path, monkeypatch):
    rc, report = _leg(tmp_path, monkeypatch, "--max-update", "8",
                      "--save-interval-updates", "2", "--inject", "spike:5")
    assert rc == 0 and report["bit_exact"]
    assert report["injection"] == {"kind": "spike", "dispatch": 5,
                                   "skipped": True, "action": "skip"}


def test_data_corrupt_leg_matches_the_skip_oracle(tmp_path, monkeypatch):
    rc, report = _leg(tmp_path, monkeypatch, "--data", "corrupt:2")
    assert rc == 0 and report["bit_exact"]
    data = report["data"]
    assert data["skips_epoch1"] == 2 and data["skip_log_match"]
    assert sorted(e["index"] for e in data["skips"]
                  if e["epoch"] == 1) == data["corrupt_indices"]


def test_pieces_equal_the_jax_tools(tmp_path):
    """The corpus files byte for byte, the same torn records, the same
    trajectory verdicts and the same skip oracle as the JAX tool's."""
    tool = jax_tool()
    a = chaos.build_corpus(str(tmp_path / "port"), seed=7)
    b = tool.build_corpus(str(tmp_path / "jax"), seed=7)
    for name in ("dict.txt", "train.rec", "train.rec.idx", "valid.rec"):
        with open(os.path.join(a, name), "rb") as f, \
                open(os.path.join(b, name), "rb") as g:
            assert f.read() == g.read(), name
    assert chaos.corrupt_train_records(a, 3, 7) == \
        tool.corrupt_train_records(b, 3, 7)
    oracle = [{"dispatch": d, "loss": 1.5 + d, "skipped": d == 2,
               "action": "skip" if d == 2 else "none", "update": d,
               "streak": int(d == 2)} for d in range(5)]
    chaos_recs = [dict(r) for r in oracle[2:]] + [dict(oracle[4], loss=9.0),
                                                   dict(oracle[0],
                                                        dispatch=7)]
    assert chaos.compare_trajectories(oracle, chaos_recs) == \
        tool.compare_trajectories(oracle, chaos_recs)
    entries = [{"epoch": e, "index": i} for e in (1, 2) for i in (3, 50, 70)]
    assert chaos.predict_skips(entries, [3, 50, 70, 12], 7, 96) == \
        tool.predict_skips(entries, [3, 50, 70, 12], 7, 96)
