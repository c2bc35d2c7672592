"""Port parity: one PV-RCNN++ train step against JAX's `make_train_step`,
on the CPU, fp32 on both sides, at tests/test_torch_port_pvrcnn_pp.py's
test-scale config and weights (`pp_pair`), with the checks of
tests/test_torch_port_two_stage_train.py: sampled RoIs equal, metrics
within 1e-5 relative, every gradient leaf within 1e-4 of its largest entry
and nonzero in the reg branch.
"""
from test_torch_port_pvrcnn_pp import pp_pair
from test_torch_port_threads import few_threads  # noqa: F401 (autouse)
from test_torch_port_two_stage_train import check_model_train_step


def test_train_step_matches_jax(monkeypatch):
    """JAX draws 3 dropout masks (SHARED_FC's one, CLS_FC's and REG_FC's)."""
    jmodel, variables, model, _ = pp_pair(seed=2, train=True)
    check_model_train_step(jmodel, variables, model, ("reg_fc.",), 3, monkeypatch)
