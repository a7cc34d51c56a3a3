"""The check's control and its faults, on the CPU at a small size.

Each drives a whole run of a cell (set-up, window, check) with the timed
path changed underneath, and sees ``correct`` come out false: the program
in float32, the configuration's float64 stated; a sampler step that
returns its state unchanged; half of the chains' evidence left out and the
mean of the rest put in its place; one answer (a draw's theta) altered
where the pipeline produces it. A sound run at the same size is correct.
(The cells run on one card, so there is no exchange between cards to
leave out.)"""

import pytest
import torch

from benchmark import run

SMALL = {"config": {"num_chains": 512, "num_warmup": 20, "num_samples": 40},
         "traffic": {"num_particles": 64, "min_solves": 1}}


def _run(workload, overrides=SMALL, hook=None):
    res = run.run_cell(workload, 987654321012, 0.0, False, device="cpu", overrides=overrides,
                       program_hook=hook)
    failed = {k for k, v in res["checks"].items() if v["value"] is None or v["value"] > v["limit"]}
    return res["correct"], failed


@pytest.mark.parametrize("workload", ["cfg4.chees.f64", "cfg3.chees.f64"])
def test_sound_run_is_correct(workload):
    assert _run(workload) == (True, set())


@pytest.mark.parametrize("workload", ["cfg4.chees.f64", "cfg3.chees.f64"])
def test_control_float32_fails(workload):
    over = {"config": SMALL["config"], "traffic": {**SMALL["traffic"], "dtype": "float32"}}
    correct, failed = _run(workload, over)
    assert not correct
    assert {"theta_gap", "logp_gap", "ll_gap", "grad_gap"} <= failed


def test_unchanged_state_fails(monkeypatch):
    from gptools_tpu_torch.infer import chees

    step = chees.chees_step

    def frozen(logp_and_grad, state, *a, **k):
        new, stats = step(logp_and_grad, state, *a, **k)
        return new._replace(qs=state.qs, logps=state.logps, grads=state.grads), stats

    monkeypatch.setattr(chees, "chees_step", frozen)
    correct, failed = _run("cfg4.chees.f64")
    assert not correct and "mean_z" in failed


def test_half_the_chains_left_out_fails():
    def hook(model, data):
        inner = model.log_marginal_batch

        def half(thetas, data_, *a, **k):
            ll = inner(thetas, data_, *a, **k)
            h = ll.shape[0] // 2
            return torch.cat([ll[:h], ll[:h].mean().expand(ll.shape[0] - h)])

        model.log_marginal_batch = half

    # a broken density sends the step-size search to long trajectories;
    # max_steps keeps the test short
    over = {"config": SMALL["config"], "traffic": {**SMALL["traffic"], "max_steps": 16}}
    correct, failed = _run("cfg4.chees.f64", over, hook=hook)
    assert not correct and {"logp_gap", "ll_gap"} <= failed


def test_altered_answer_fails(monkeypatch):
    from gptools_tpu_torch.infer import pipeline

    finish = pipeline._finish

    def altered(model, res, smc_res):
        out = finish(model, res, smc_res)
        out.thetas[3, -1, 1] *= 1.0 + 1e-9
        return out

    monkeypatch.setattr(pipeline, "_finish", altered)
    correct, failed = _run("cfg4.chees.f64")
    assert not correct and failed == {"theta_gap"}
