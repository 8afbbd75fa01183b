"""The port's data-parallel union step with ``unify_copies`` off against
the JAX package's, on the CPU: ``test_torch_dp_union.py``'s case at 1024
points and 256 keypoints, through ``make_train_step(mesh=make_mesh(2),
graph_builder=..., frames_per_device=2, unify_copies=False)`` and two
spawned gloo ranks.  Each rank backpropagates ``(cls + loc + reg) /
n_dev`` of its own union, and the losses it reports are the ``pmean``
of the ranks'.  Tolerances as in ``test_torch_dp_step.py``.
"""

import pytest

from test_torch_dp_union import check_union, union_runs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return union_runs(str(tmp_path_factory.mktemp("dp_union_plain")),
                      unify_copies=False, num_points=1024, num_keypoints=256)


def test_multi_frame_dp_without_unify_matches_jax_mesh(runs):
    """The per-device union losses averaged over the ranks, each
    device's endpoint counts and classwise losses, and the updated
    parameters; both ranks equal bit for bit."""
    check_union(runs)
