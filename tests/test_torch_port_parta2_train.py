"""Port parity: one PartA2 (PartA2Net) train step against JAX's
`make_train_step`, on the CPU, fp32 on both sides, from the same numpy
inputs and weights, at tests/test_parta2.py's test-scale config, with the
checks of tests/test_torch_port_two_stage_train.py: sampled RoIs equal,
metrics within 1e-5 relative, every gradient leaf within 1e-4 of its
largest entry and nonzero in the reg branch, the parameters and BN
statistics after the step.
"""
from test_parta2 import pa2_cfg, pa2_grid
from test_torch_port_threads import few_threads  # noqa: F401 (autouse)
from test_torch_port_two_stage import build_pair
from test_torch_port_two_stage_train import check_model_train_step


def test_train_step_matches_jax(monkeypatch):
    """JAX draws 3 dropout masks (SHARED_FC's one, CLS_FC's and REG_FC's)."""
    jmodel, variables, model, _ = build_pair(pa2_cfg(), pa2_grid(), seed=2, train=True)
    check_model_train_step(jmodel, variables, model, ("roi_head.reg_fc.",), 3, monkeypatch)
