"""The port's training launcher (``python -m repro_torch.launch.train``)
end to end on the CPU: ``tests/test_system.py``'s launcher tests on the
port, with ``--device cpu --reduced``, run in-process.

A resumed run must reproduce the uninterrupted run's losses bitwise: the
data stream is a pure function of (seed, step), the schedule of the step,
and the checkpoint keeps every float32 leaf exactly.
"""
import pytest
import torch

from repro_torch.examples import train_lm
from repro_torch.launch import train

ARGS = ["--arch", "smollm-135m", "--reduced", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's small tensors: as fast alone,
    and it spares the suite's other parallel workers an oversubscribed
    CPU (with a thread per core in every worker, each small op's thread
    team waits on the others)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loss_line(out):
    first = float(out.split("loss ")[-1].split(" ->")[0])
    last = float(out.strip().split("-> ")[-1])
    return first, last


def test_train_launcher_end_to_end(tmp_path, capsys):
    rc = train.main(ARGS + ["--steps", "25", "--batch", "4", "--seq", "64",
                            "--ckpt-dir", str(tmp_path), "--save-every",
                            "10"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "arch=smollm-135m-reduced params=0.09M start_step=0" in out
    assert "done: steps=25" in out
    first, last = _loss_line(out)
    assert last < first
    # checkpoints exist and resume works
    rc = train.main(ARGS + ["--steps", "30", "--batch", "4", "--seq", "64",
                            "--ckpt-dir", str(tmp_path), "--save-every",
                            "10"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "start_step=25" in out and "done: steps=5" in out


def test_failure_injection_and_bitwise_resume(tmp_path, capsys):
    """--inject-failure-at 12 exits 75; the rerun resumes at step 10 (the
    last save) and its losses are bitwise the uninterrupted run's."""
    args = ARGS + ["--steps", "20", "--batch", "2", "--seq", "32",
                   "--save-every", "5"]
    ap = train.build_parser()
    whole = train.train(ap.parse_args(args + ["--ckpt-dir",
                                              str(tmp_path / "a")]))
    killed = train.train(ap.parse_args(args + [
        "--ckpt-dir", str(tmp_path / "b"), "--inject-failure-at", "12"]))
    assert whole.rc == 0 and killed.rc == 75 and killed.history == []
    assert "[ft] simulated preemption at step 12" in capsys.readouterr().out
    resumed = train.train(ap.parse_args(args + ["--ckpt-dir",
                                                str(tmp_path / "b")]))
    assert resumed.rc == 0 and resumed.start == 10
    assert "start_step=10" in capsys.readouterr().out
    assert [h["step"] for h in resumed.history] == list(range(10, 20))
    assert [h["loss"] for h in resumed.history] == \
        [h["loss"] for h in whole.history[10:]]


def test_scale_config_and_param_count():
    from repro_torch.configs import get_config
    cfg = train.scale_config(get_config("smollm-135m"), d_model=192,
                             n_layers=6, vocab=2048)
    assert (cfg.d_model, cfg.hd, cfg.n_layers, cfg.vocab) == (192, 21, 6,
                                                              2048)
    assert train.scale_config(cfg) is cfg


def test_train_example_runs_on_cpu(tmp_path, capsys):
    """The example's configuration (d 576, 6 layers, vocab 2048: 22.4 M
    parameters), one step."""
    rc = train_lm.main(["--device", "cpu", "--steps", "1", "--ckpt-dir",
                        str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0 and "done: steps=1" in out
    assert "arch=smollm-135m params=22.42M" in out


def test_launcher_and_example_default_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: train.main(["--reduced", "--steps", "1",
                                     "--ckpt-dir", str(tmp_path)]),
                 lambda: train_lm.main(["--steps", "1", "--ckpt-dir",
                                        str(tmp_path)])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
