"""The pose optimiser (hive_tpu_torch.pose_optimisation, checkpoint) against
hive_tpu's on the same inputs, on the CPU: frame-pair sampling and the
feature-set containers equal; the loss and its gradients (autograd against
jax.value_and_grad) on every residual x alignment x smoothing configuration
and trajectory length; one 25-epoch Adam chunk in optax's order; the whole
optimisation (pairwise, global and fine-tune steps, with early stopping);
ForegroundPoseOptimiser's AdamW; the post-processing; checkpoints resumed
across the packages; the feature-set cache and the extraction refusal; the
standalone CLI. Three faults planted in the port must each fail the chunk
comparison.

Tolerances: the loss within rtol 1e-5 and each gradient within 1e-5 of its
largest entry (float32 in both, summed in another order); a chunk's losses
within rtol 1e-5 and its parameters within 1e-6, frame 0 bit-equal; a whole
optimisation's trajectory within 1e-4."""

import json
import os
import shutil
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hive_tpu import pose_optimisation as J
from hive_tpu.checkpoint import CheckpointManager as JaxCheckpointManager
from hive_tpu.geometric import Trajectory as JaxTrajectory
from hive_tpu.io import HiveDataset as JaxHiveDataset
from hive_tpu_torch import pose_optimisation as P
from hive_tpu_torch.checkpoint import CheckpointManager
from hive_tpu_torch.geometric import Trajectory
from hive_tpu_torch.io import HiveDataset
from tests.helpers import make_synthetic_hive_dataset
from tests.test_pose_optimisation import _FakeDataset, _SyntheticProblem

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5       # of each gradient's largest entry
CHUNK_PARAM_TOL = 1e-6
RUN_TOL = 1e-4
# A float32 run whose steps chain into rounding noise: about twice hive_tpu's
# own sensitivity to a 1e-6 change in its input (5.7e-3); see
# test_optimise_pose_matches.
CHAINED_TOL = 1.2e-2
FRAME_SIZE = (128, 96)


def problem_inputs(num_frames=8, seed=1, scale=0.05):
    """The synthetic problem of tests/test_pose_optimisation.py: hierarchical
    pairs' exact correspondences and a perturbed trajectory."""
    problem = _SyntheticProblem(num_frames=num_frames)
    pairs = J.sample_frame_pairs(J.FrameSamplingMode.Hierarchical, num_frames)
    feature_set = problem.feature_set(pairs)
    rng = np.random.default_rng(seed)
    perturbed = problem.gt.copy()
    perturbed[1:, 4:] += rng.normal(scale=scale, size=(num_frames - 1, 3))
    return problem, feature_set, perturbed


def packed(feature_set):
    K = feature_set.camera_matrix
    intrinsics = [K[0, 0], K[1, 1], K[0, 2], K[1, 2]]
    return ((J.PoseOptimiser._pack_features(feature_set), jnp.asarray(intrinsics, jnp.float32)),
            (P.PoseOptimiser._pack_features(feature_set, device="cpu"),
             torch.tensor(intrinsics, dtype=torch.float32)))


def make_params(perturbed, alignment, rng):
    n = len(perturbed)
    shape = {"Rigid": (0,), "Affine": (n,), "Deformable": (n, 3, 3)}[alignment]
    rigid = alignment == "Rigid"
    return {"q": perturbed[:, :4].astype(np.float32), "t": perturbed[:, 4:].astype(np.float32),
            "scale": np.zeros(shape, np.float32) if rigid
            else (1 + 0.05 * rng.normal(size=shape)).astype(np.float32),
            "shift": np.zeros(shape, np.float32) if rigid
            else (0.05 * rng.normal(size=shape)).astype(np.float32)}


def loss_fns(residual, alignment, smooth, **overrides):
    kwargs = dict(residual_type=J.ResidualType[residual], alignment=J.AlignmentType[alignment],
                  smooth=smooth, position_only=False, pose_t_reg=0.5, pose_r_reg=1.0,
                  l2_reg=0.5, frame_size=FRAME_SIZE, **overrides)
    ours = dict(kwargs, residual_type=P.ResidualType[residual],
                alignment=P.AlignmentType[alignment])
    return J._make_loss_fn(**kwargs), P._make_loss_fn(**ours)


# ---------------------------------------------------------------------------
# Host containers.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", [m.name for m in J.FrameSamplingMode])
def test_sample_frame_pairs_equal(mode):
    for n in range(1, 41):
        assert P.sample_frame_pairs(P.FrameSamplingMode[mode], n) == \
            J.sample_frame_pairs(J.FrameSamplingMode[mode], n), n
    assert len(P.sample_frame_pairs(P.FrameSamplingMode.Hierarchical, 300)) == 593


def feature_sets(seed=5, m=200, frames=12):
    rng = np.random.default_rng(seed)
    i = rng.integers(0, frames - 1, m)
    j = np.minimum(i + rng.integers(1, 4, m), frames - 1)
    arrays = (np.eye(3) * 100, i.astype(np.int64), rng.normal(size=(m, 2)).astype(np.float32),
              rng.uniform(1, 3, m).astype(np.float32), j.astype(np.int64),
              rng.normal(size=(m, 2)).astype(np.float32), rng.uniform(1, 3, m).astype(np.float32))
    return [module.FeatureSet(arrays[0], module.FeatureData(*arrays[1:4]),
                              module.FeatureData(*arrays[4:])) for module in (J, P)]


def assert_same_features(ours, theirs):
    np.testing.assert_array_equal(ours.camera_matrix, theirs.camera_matrix)
    for side in ("frame_i", "frame_j"):
        for field in ("index", "points", "depth"):
            got, want = getattr(getattr(ours, side), field), getattr(getattr(theirs, side), field)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_feature_set_subsets_equal():
    theirs, ours = feature_sets()
    for frames in ([0, 1, 2, 5], range(12), [3], []):
        assert_same_features(ours.sample_at(frames), theirs.sample_at(frames))
    pairs = J.sample_frame_pairs(J.FrameSamplingMode.Hierarchical, 12) + [(4, 40)]
    for subset in (pairs, [(0, 1)], [(2, 5), (6, 7)]):
        assert_same_features(ours.subset_from(subset), theirs.subset_from(subset))
    assert len(P.FeatureSet().subset_from([(0, 1)])) == 0


def test_feature_set_npz_loads_in_both_packages(tmp_path):
    theirs, ours = feature_sets()
    theirs.save(str(tmp_path / "jax.npz"))
    ours.save(str(tmp_path / "torch.npz"))
    assert_same_features(P.FeatureSet.load(str(tmp_path / "jax.npz")), theirs)
    assert_same_features(J.FeatureSet.load(str(tmp_path / "torch.npz")), theirs)
    with np.load(str(tmp_path / "torch.npz")) as a, np.load(str(tmp_path / "jax.npz")) as b:
        assert a.files == b.files


# ---------------------------------------------------------------------------
# The loss and its gradients.
# ---------------------------------------------------------------------------

# The smoothness terms are guarded on the trajectory's length (2, 3, 4
# frames); without them the length changes only the shapes.
@pytest.mark.parametrize("smooth, num_frames", [(True, 2), (True, 3), (True, 4), (True, 8),
                                                (False, 8)],
                         ids=["smooth-2", "smooth-3", "smooth-4", "smooth-8", "rough-8"])
@pytest.mark.parametrize("alignment", ["Rigid", "Affine", "Deformable"])
@pytest.mark.parametrize("residual", ["World3D", "Image2D"])
def test_loss_and_gradients_match(residual, alignment, smooth, num_frames):
    _, feature_set, perturbed = problem_inputs()
    feature_set = feature_set.sample_at(range(num_frames))
    assert len(feature_set) > 20
    (feats_j, intr_j), (feats_t, intr_t) = packed(feature_set)
    params = make_params(perturbed[:num_frames], alignment, np.random.default_rng(num_frames))
    jax_loss, torch_loss = loss_fns(residual, alignment, smooth)

    value, grads = jax.jit(jax.value_and_grad(jax_loss))(
        {k: jnp.asarray(v) for k, v in params.items()}, feats_j, intr_j)
    ours, our_grads = P._loss_and_grads(torch_loss, {k: torch.as_tensor(v)
                                                     for k, v in params.items()},
                                        feats_t, intr_t)
    assert np.isfinite(float(value))
    np.testing.assert_allclose(float(ours), float(value), rtol=LOSS_RTOL)
    for key in P.PARAM_KEYS:
        want = np.asarray(grads[key])
        got = our_grads[key].numpy()
        assert got.shape == want.shape and got.dtype == want.dtype
        if want.size:
            assert np.abs(want).max() > 0
            np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_TOL * np.abs(want).max(),
                                       err_msg=key)


def test_clip_frame_distances_match():
    rng = np.random.default_rng(9)
    positions = np.cumsum(rng.normal(scale=0.05, size=(40, 3)), axis=0).astype(np.float32)
    positions[17] += 2.0  # one wild jump
    for limit in (1.0 / 30, 0.01, 10.0):
        want = np.asarray(J._clip_frame_distances(jnp.asarray(positions), jnp.float32(limit)))
        got = P._clip_frame_distances(torch.as_tensor(positions),
                                      torch.tensor(limit, dtype=torch.float32)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        steps = np.linalg.norm(np.diff(got, axis=0), axis=-1)
        assert steps.max() <= limit * (1 + 1e-5)


# ---------------------------------------------------------------------------
# One 25-epoch chunk: Adam in optax's order.
# ---------------------------------------------------------------------------

CHUNK = dict(num_epochs=25, lr=1e-2, max_frame_distance=1.0 / 30)


@pytest.fixture(scope="module")
def chunk_inputs():
    _, feature_set, perturbed = problem_inputs()
    (feats_j, intr_j), (feats_t, intr_t) = packed(feature_set)
    params = make_params(perturbed, "Rigid", None)
    jax_loss, _ = loss_fns("World3D", "Rigid", True)
    start = {k: jnp.asarray(v) for k, v in params.items()}
    out, _, losses = J._run_epoch_chunk(
        start, optax.adam(1.0).init(start), feats_j, intr_j, jnp.float32(CHUNK["lr"]),
        jnp.float32(CHUNK["max_frame_distance"]), loss_fn=jax_loss,
        num_epochs=CHUNK["num_epochs"], position_only=False, use_clip=True)
    return params, (feats_t, intr_t), ({k: np.asarray(v) for k, v in out.items()},
                                       np.asarray(losses))


def port_chunk(params, feats, intrinsics):
    _, torch_loss = loss_fns("World3D", "Rigid", True)
    start = {k: torch.as_tensor(v) for k, v in params.items()}
    out, state, losses = P._run_epoch_chunk(
        start, P.adam_init(start), feats, intrinsics, torch.tensor(CHUNK["lr"]),
        torch.tensor(CHUNK["max_frame_distance"], dtype=torch.float32), loss_fn=torch_loss,
        num_epochs=CHUNK["num_epochs"], position_only=False, use_clip=True)
    assert int(state["count"]) == CHUNK["num_epochs"]
    return {k: v.numpy() for k, v in out.items()}, losses.numpy()


def assert_chunk_matches(chunk_inputs):
    params, (feats, intrinsics), (want, want_losses) = chunk_inputs
    got, losses = port_chunk(params, feats, intrinsics)
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    for key in ("q", "t"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=CHUNK_PARAM_TOL,
                                   err_msg=key)
        np.testing.assert_array_equal(got[key][0], params[key][0] / (
            np.linalg.norm(params[key][0]) if key == "q" else 1))
    return got


def test_epoch_chunk_matches(chunk_inputs):
    params, _, (want, _) = chunk_inputs
    got = assert_chunk_matches(chunk_inputs)
    assert np.abs(got["t"][1:] - params["t"][1:]).max() > 1e-3  # the chunk moved the frames


def _no_pin(grads, position_only):
    pass


@torch.no_grad()
def _adam_without_bias_correction(grads, state):
    state["count"] = state["count"] + 1
    directions = {}
    for key, g in grads.items():
        state["mu"][key] = 0.1 * g + 0.9 * state["mu"][key]
        state["nu"][key] = 0.001 * g * g + 0.999 * state["nu"][key]
        directions[key] = state["mu"][key] / (torch.sqrt(state["nu"][key]) + 1e-8)
    return directions


@torch.no_grad()
def _project_without_normalising(params, max_frame_distance, use_clip):
    params = dict(params)
    if use_clip:
        params["t"] = P._clip_frame_distances(params["t"], max_frame_distance)
    return params


@pytest.mark.parametrize("name, fault", [
    ("_pin_first_frame", _no_pin),
    ("adam_directions", _adam_without_bias_correction),
    ("_project_params", _project_without_normalising)],
    ids=["no_frame0_pin", "adam_without_bias_correction", "q_not_renormalised"])
def test_planted_fault_fails_the_chunk_check(chunk_inputs, monkeypatch, name, fault):
    monkeypatch.setattr(P, name, fault)
    with pytest.raises(AssertionError):
        assert_chunk_matches(chunk_inputs)


# ---------------------------------------------------------------------------
# The whole optimisation.
# ---------------------------------------------------------------------------

def count_epochs(monkeypatch, module):
    counted = []
    original = module._run_epoch_chunk

    def counting(*args, **kwargs):
        counted.append(kwargs["num_epochs"])
        return original(*args, **kwargs)

    monkeypatch.setattr(module, "_run_epoch_chunk", counting)
    return counted


def optimise_pose(module, problem, feature_set, perturbed, steps, fine_tune, **extra):
    options = module.OptimisationOptions(
        num_epochs=200, learning_rate=5e-3, fine_tune=fine_tune, clip_distance=1.0,
        lr_scheduler_patience=10, early_stopping_patience=15,
        steps=tuple(module.OptimisationStep[step] for step in steps))
    optimiser = module.PoseOptimiser(_FakeDataset(problem, perturbed), debug=False,
                                     optimisation_options=options, **extra)
    params = optimiser._optimise_pose(feature_set, optimiser._init_params(perturbed),
                                      len(perturbed))
    return optimiser._params_to_trajectory(params).values


STEPS = {"pairwise": (("PairWise3D",), False), "global": (("Global3D",), False),
         "global_finetune": (("Global3D",), True),
         "pairwise_global_finetune": (("PairWise3D", "Global3D"), True)}


@pytest.mark.parametrize("steps", list(STEPS))
def test_optimise_pose_matches(monkeypatch, steps):
    """PoseOptimiser._optimise_pose in float32, as the CLI runs it:
    PairWise3D (two no-overlap passes and the chaining), Global3D and the
    fine-tune, 200 epochs a loop at most, the plateau scheduler and early
    stopping on: the same epochs run in each loop and the same trajectory
    within RUN_TOL.

    Chained, the steps reach coordinates whose gradients are float32
    rounding noise, where an Adam step is about +-lr whatever the
    gradient's size, so the result depends on the last bits of the input:
    hive_tpu's own moves by more than RUN_TOL (5.7e-3 here) when its input
    moves by 1e-6. There the port is held within CHAINED_TOL, and in
    float64 within RUN_TOL (test_optimise_packed_features_matches); the
    trajectory must move by more than 5 CHAINED_TOL (0.37 m here), so a
    wrong hand-off between the steps cannot hide in the bound."""
    problem, feature_set, perturbed = problem_inputs(seed=4, scale=0.04)
    names, fine_tune = STEPS[steps]
    results, epochs = {}, {}
    for name, module, extra in (("jax", J, {}), ("torch", P, {"device": "cpu"})):
        epochs[name] = count_epochs(monkeypatch, module)
        results[name] = optimise_pose(module, problem, feature_set, perturbed, names,
                                      fine_tune, **extra)
    assert np.abs(results["jax"][:, 4:] - perturbed[:, 4:]).max() > 1e-2
    if steps != "pairwise_global_finetune":
        assert epochs["torch"] == epochs["jax"]
        assert sum(epochs["jax"]) < 200 * len(epochs["jax"])  # some loop stopped early
        np.testing.assert_allclose(results["torch"], results["jax"], rtol=0, atol=RUN_TOL)
        return
    moved = perturbed.copy()
    moved[1:, 4] += 1e-6
    sensitivity = np.abs(optimise_pose(J, problem, feature_set, moved, names, fine_tune)
                         - results["jax"]).max()
    assert sensitivity > RUN_TOL
    assert np.abs(results["jax"][:, 4:] - perturbed[:, 4:]).max() > 5 * CHAINED_TOL
    np.testing.assert_allclose(results["torch"], results["jax"], rtol=0, atol=CHAINED_TOL)


# Two steps and the fine-tune through optimise_packed_features.
PACKED_SEQUENCE = (("World3D", True), ("Image2D", True), ("World3D", False))


def packed_sequence(module, features, intrinsics, params):
    for residual, smooth in PACKED_SEQUENCE:
        options = module.OptimisationOptions(num_epochs=200, learning_rate=5e-3,
                                             clip_distance=None, lr_scheduler_patience=10,
                                             early_stopping_patience=15)
        params = module.optimise_packed_features(
            features, intrinsics, params, options,
            residual_type=module.ResidualType[residual], frame_size=FRAME_SIZE, fps=30.0,
            smooth_trajectory=smooth)
    return {k: np.asarray(v) for k, v in params.items()}


def test_optimise_packed_features_matches(monkeypatch):
    """optimise_packed_features on the 8-frame problem in float64 (JAX in
    its x64 mode, the port in the features' dtype): Global3D, Global2D and
    the fine-tune, 200 epochs a loop at most, with the plateau scheduler and
    early stopping: the same epochs in each loop, the trajectory within
    RUN_TOL (measured 1.9e-9) and near the ground truth."""
    problem, feature_set, perturbed = problem_inputs(seed=4, scale=0.04)
    (feats_j, intr_j), (feats_t, intr_t) = packed(feature_set)
    params = {k: v.astype(np.float64) for k, v in make_params(perturbed, "Rigid", None).items()}
    epochs = {"jax": count_epochs(monkeypatch, J)}
    with jax.enable_x64(True):
        want = packed_sequence(
            J, {k: v.astype(jnp.float64) if v.dtype == jnp.float32 else v
                for k, v in feats_j.items()}, intr_j.astype(jnp.float64), params)
    epochs["torch"] = count_epochs(monkeypatch, P)
    got = packed_sequence(P, {k: v.double() if v.is_floating_point() else v
                              for k, v in feats_t.items()}, intr_t.double(), params)
    assert got["t"].dtype == want["t"].dtype == np.float64
    assert epochs["torch"] == epochs["jax"] and sum(epochs["jax"]) < 600
    for key in ("q", "t"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=RUN_TOL)
    error = np.linalg.norm(got["t"] - problem.gt[:, 4:])
    assert error < 0.35 * np.linalg.norm(perturbed[:, 4:] - problem.gt[:, 4:])


def test_post_processing_matches():
    rng = np.random.default_rng(11)
    values = np.hstack([rng.normal(size=(12, 4)), rng.normal(size=(12, 3))])
    values[:, :4] /= np.linalg.norm(values[:, :4], axis=1, keepdims=True)
    theirs, ours = feature_sets(frames=12)
    keep = ~np.isin(theirs.frame_i.index, [3, 4, 5, 9]) & ~np.isin(theirs.frame_j.index,
                                                                  [3, 4, 5, 9, 11])
    want = J.PoseOptimiser._interpolate_poses_without_matches(
        J.FeatureSet(theirs.camera_matrix, theirs.frame_i.sample_at(keep),
                     theirs.frame_j.sample_at(keep)), JaxTrajectory(values.copy())).values
    got = P.PoseOptimiser._interpolate_poses_without_matches(
        P.FeatureSet(ours.camera_matrix, ours.frame_i.sample_at(keep),
                     ours.frame_j.sample_at(keep)), Trajectory(values.copy())).values
    assert not np.allclose(want, values)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for weight in (0.9, 0.5):
        np.testing.assert_allclose(
            P.PoseOptimiser._smooth_trajectory(Trajectory(values.copy()), weight).values,
            J.PoseOptimiser._smooth_trajectory(JaxTrajectory(values.copy()), weight).values,
            rtol=0, atol=1e-6)


def test_adamw_step_matches_optax():
    """ForegroundPoseOptimiser's update is optax.adamw's, step for step."""
    rng = np.random.default_rng(12)
    params = {"q": rng.normal(size=(9, 4)).astype(np.float32),
              "t": rng.normal(size=(9, 3)).astype(np.float32)}
    optimiser = optax.adamw(learning_rate=0.1, weight_decay=1e-4)
    want = {k: jnp.asarray(v) for k, v in params.items()}
    state = optimiser.init(want)
    got = {k: torch.as_tensor(v) for k, v in params.items()}
    ours = P.adam_init(got)
    for step in range(20):
        grads = {k: rng.normal(scale=10.0 ** -(step % 4), size=v.shape).astype(np.float32)
                 for k, v in params.items()}
        updates, state = optimiser.update({k: jnp.asarray(g) for k, g in grads.items()}, state,
                                          want)
        want = optax.apply_updates(want, updates)
        got = P.adamw_step(got, {k: torch.as_tensor(g) for k, g in grads.items()}, ours, 0.1,
                           P.FOREGROUND_WEIGHT_DECAY)
    for key in params:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=1e-6)
    assert int(ours["count"]) == 20


def jittered_dataset(path):
    """The helper's dataset with a jittered trajectory: on its straight,
    unrotated one the smoothness terms' gradients are rounding noise."""
    path = make_synthetic_hive_dataset(path, num_frames=8)
    jittered = Trajectory.load(os.path.join(path, "camera_trajectory.txt")).values
    rng = np.random.default_rng(6)
    jittered[:, :3] = 0.02 * rng.normal(size=(8, 3))
    jittered[:, :4] /= np.linalg.norm(jittered[:, :4], axis=1, keepdims=True)
    jittered[:, 4:] += 0.01 * rng.normal(size=(8, 3))
    np.savetxt(os.path.join(path, "camera_trajectory.txt"), jittered)
    return path, jittered


@pytest.mark.parametrize("learning_rate", [1e-5, 1e-3])
def test_foreground_pose_optimiser_matches(tmp_path, learning_rate):
    """20 AdamW epochs on the blob's centroids. At the CLI's default lr
    (1e-5) within 1e-5 (the frames move by 2e-4). At lr 1e-3 the geometric
    term's gradient at the start is rounding noise (the centroids' world
    positions are those of the starting trajectory), which Adam turns into
    a step of about lr: hive_tpu's own result moves by more than 1e-5 when
    its trajectory moves by 1e-7, and the port is held within 2 lr."""
    path, start = jittered_dataset(tmp_path / "ds")
    want = J.ForegroundPoseOptimiser(JaxHiveDataset(path), learning_rate=learning_rate,
                                     num_epochs=20).run().values
    got = P.ForegroundPoseOptimiser(HiveDataset(path), learning_rate=learning_rate,
                                    num_epochs=20, device="cpu").run().values
    assert np.abs(want - start).max() > 10 * learning_rate
    if learning_rate == 1e-5:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        return
    moved = start.copy()
    moved[:, 4] += 1e-7
    np.savetxt(os.path.join(path, "camera_trajectory.txt"), moved)
    again = J.ForegroundPoseOptimiser(JaxHiveDataset(path), learning_rate=learning_rate,
                                      num_epochs=20).run().values
    assert np.abs(again - want).max() > 1e-5
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * learning_rate)


# ---------------------------------------------------------------------------
# Checkpoints across the packages.
# ---------------------------------------------------------------------------

def checkpointed_run(module, feature_set, perturbed, directory, num_epochs):
    options = module.OptimisationOptions(num_epochs=num_epochs, learning_rate=5e-3,
                                         checkpoint_dir=str(directory),
                                         checkpoint_every_chunks=1)
    (feats_j, intr_j), (feats_t, intr_t) = packed(feature_set)
    feats, intr = (feats_j, intr_j) if module is J else (feats_t, intr_t)
    params = make_params(perturbed, "Rigid", None)
    out = module.optimise_packed_features(
        feats, intr, params, options, residual_type=module.ResidualType.World3D,
        frame_size=FRAME_SIZE, fps=30.0)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_resumes_in_the_other_package(tmp_path, writer):
    """One package runs 50 epochs, checkpointing every 25-epoch chunk; the
    other resumes from its epoch-25 checkpoint and must end where the writer
    did, within the chunk tolerance."""
    _, feature_set, perturbed = problem_inputs()
    modules = {"jax": J, "torch": P}
    reader = "torch" if writer == "jax" else "jax"
    written = checkpointed_run(modules[writer], feature_set, perturbed, tmp_path / "w", 50)
    manager = (JaxCheckpointManager if writer == "jax" else CheckpointManager)(str(tmp_path / "w"))
    assert manager.all_steps() == [25, 50]
    leaves, meta = manager.restore(25)
    assert isinstance(leaves, list) and len(leaves) == 13 and meta["epochs_done"] == 25
    assert leaves[4].dtype == np.int32 and int(leaves[4]) == 25  # Adam's count
    os.makedirs(tmp_path / "r")
    shutil.copy(manager._step_path(25), tmp_path / "r")
    resumed = checkpointed_run(modules[reader], feature_set, perturbed, tmp_path / "r", 50)
    for key in ("q", "t"):
        np.testing.assert_allclose(resumed[key], written[key], rtol=0, atol=CHUNK_PARAM_TOL)
    assert np.abs(written["t"] - perturbed[:, 4:]).max() > 1e-3


def test_checkpoint_files_hold_the_same_arrays(tmp_path):
    """Both managers write the same members (``#0``.. and ``__metadata__``)
    with equal arrays and dtypes, keep the latest three steps, and each
    restores the other's list; a checkpoint of anything but a list is
    refused."""
    rng = np.random.default_rng(8)
    leaves = [rng.normal(size=(5, 4)).astype(np.float32), np.zeros(0, np.float32),
              np.int32(7), rng.normal(size=(5, 3))]
    managers = {"jax": JaxCheckpointManager(str(tmp_path / "jax")),
                "torch": CheckpointManager(str(tmp_path / "torch"))}
    for manager in managers.values():
        for step in range(1, 6):
            manager.save(step, leaves, metadata={"epochs_done": step, "lr": 1e-3})
        assert manager.all_steps() == [3, 4, 5]
    files = {name: np.load(manager._step_path(5)) for name, manager in managers.items()}
    assert files["torch"].files == files["jax"].files
    for key in files["jax"].files:
        assert files["torch"][key].dtype == files["jax"][key].dtype
        np.testing.assert_array_equal(files["torch"][key], files["jax"][key])
    for reader, writer in (("torch", "jax"), ("jax", "torch")):
        restored, meta = type(managers[reader])(str(tmp_path / writer)).restore()
        assert isinstance(restored, list) and meta == {"epochs_done": 5, "lr": 1e-3}
        for got, want in zip(restored, leaves, strict=True):
            assert got.dtype == np.asarray(want).dtype
            np.testing.assert_array_equal(got, want)
    JaxCheckpointManager(str(tmp_path / "tree")).save(1, {"q": leaves[0]})
    with pytest.raises(ValueError, match="does not hold a list"):
        CheckpointManager(str(tmp_path / "tree")).restore()


# ---------------------------------------------------------------------------
# PoseOptimiser.run, the feature-set cache and the CLI.
# ---------------------------------------------------------------------------

def write_feature_cache(path, num_frames, problem):
    """A HIVE dataset's pose_optim folder with a cache that hive_tpu's
    extractor keeps: frame_pairs.txt, feature_options.json (its defaults)
    and feature_set.npz of the problem's correspondences."""
    debug = os.path.join(path, J.PoseOptimiser.DEBUG_FOLDER)
    pairs = J.sample_frame_pairs(J.FrameSamplingMode.Hierarchical, num_frames)
    extractor = J.FeatureExtractor(None, pairs, J.FeatureExtractionOptions(),
                                   debug_path=debug)
    extractor._setup_cache()
    problem.feature_set(pairs).save(extractor.feature_set_path)
    return debug


def wall_hive_dataset(path, num_frames=6, width=160, height=120):
    """A HIVE dataset of the textured wall (chip_smoke's random-texture
    wall, camera sliding 1 cm a frame), converted from a TUM folder by the
    port on the CPU with the ground-truth poses."""
    from chip_smoke import wall_trajectory, write_wall_tum
    from hive_tpu_torch.dataset_adaptors import TUMAdaptor
    from hive_tpu_torch.options import InpaintingMode

    tum = str(path) + "_tum"
    write_wall_tum(tum, num_frames, width, height, wall_trajectory(num_frames))
    TUMAdaptor(tum, str(path)).convert(False, False, InpaintingMode.Off, device="cpu")
    return str(path)


@pytest.fixture
def one_thread():
    """One intra-op thread for the feature stages' many small tensor ops,
    which stall behind each other's thread barriers when test workers share
    the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_extraction_refused_without_a_valid_cache(tmp_path, monkeypatch, one_thread):
    """Without a valid cache the extractor now detects and matches the
    frames itself (it refused before) and writes hive_tpu's cache; a cache
    for other options is replaced. The pairs it keeps are hive_tpu's on the
    same dataset (both packages extract; cv2 in hive_tpu)."""
    monkeypatch.setenv("WEIGHTS_PATH", str(tmp_path / "no_weights"))
    path = wall_hive_dataset(tmp_path / "ds")
    debug = os.path.join(path, P.PoseOptimiser.DEBUG_FOLDER)
    pairs = P.sample_frame_pairs(P.FrameSamplingMode.Hierarchical, 6)
    extractor = P.FeatureExtractor(HiveDataset(path), pairs, debug_path=debug, device="cpu")
    features = extractor.extract_feature_points()
    assert sorted(os.listdir(debug)) == ["feature_options.json", "feature_set.npz",
                                         "frame_pairs.txt"]
    theirs = J.FeatureExtractor(JaxHiveDataset(path), pairs,
                                debug_path=str(tmp_path / "jax_debug")).extract_feature_points()

    def kept(feature_set):
        return set(zip(feature_set.frame_i.index.tolist(), feature_set.frame_j.index.tolist()))

    assert kept(features) == kept(theirs) and len(kept(features)) >= 5
    assert abs(len(features) - len(theirs)) <= 0.1 * len(theirs)

    # A cache for other options is not valid: it is extracted again.
    options = P.FeatureExtractionOptions(min_features=40)
    again = P.FeatureExtractor(HiveDataset(path), pairs, options, debug_path=debug,
                               device="cpu").extract_feature_points()
    with open(os.path.join(debug, "feature_options.json")) as f:
        assert json.load(f)["min_features"] == 40
    assert kept(again) <= kept(features)
    reloaded = P.FeatureSet.load(os.path.join(debug, "feature_set.npz"))
    np.testing.assert_array_equal(reloaded.frame_i.points, again.frame_i.points)


def test_pose_optimiser_extracts_features_from_frames(tmp_path, monkeypatch, one_thread):
    """PoseOptimiser.run on a dataset with no cached feature set: features
    from the frames, then the optimisation, as in hive_tpu."""
    monkeypatch.setenv("WEIGHTS_PATH", str(tmp_path / "no_weights"))
    path = wall_hive_dataset(tmp_path / "ds")
    options = P.OptimisationOptions(num_epochs=25, steps=(P.OptimisationStep.Global3D,))
    trajectory, _, _ = P.PoseOptimiser(HiveDataset(path), optimisation_options=options,
                                       device="cpu").run()
    assert len(trajectory) == 6 and np.isfinite(trajectory.values).all()
    assert os.path.isfile(os.path.join(path, "pose_optim", "feature_set.npz"))


def test_run_from_cached_features_matches(tmp_path):
    """PoseOptimiser.run on a HIVE dataset whose cached feature set hive_tpu
    keeps: both load it and give the same trajectory, scale and shift."""
    problem = _SyntheticProblem(num_frames=6)
    results = {}
    for name, module in (("jax", J), ("torch", P)):
        path = make_synthetic_hive_dataset(tmp_path / name, num_frames=6)
        write_feature_cache(path, 6, problem)
        options = module.OptimisationOptions(
            num_epochs=25, fine_tune=True, steps=(module.OptimisationStep.Global3D,),
            alignment_type=module.AlignmentType.Affine, trajectory_smoothing=0.8)
        if module is J:
            optimiser = J.PoseOptimiser(JaxHiveDataset(path), optimisation_options=options)
        else:
            optimiser = P.PoseOptimiser(HiveDataset(path), device="cpu",
                                        optimisation_options=options)
        results[name] = optimiser.run()
        assert os.path.isfile(os.path.join(path, "pose_optim", "optimised_camera_trajectory.txt"))
    (want, want_scale, want_shift), (got, scale, shift) = results["jax"], results["torch"]
    np.testing.assert_allclose(got.values, want.values, rtol=0, atol=RUN_TOL)
    np.testing.assert_allclose(scale, want_scale, rtol=0, atol=RUN_TOL)
    np.testing.assert_allclose(shift, want_shift, rtol=0, atol=RUN_TOL)
    assert scale.shape == (6,)


def test_pose_cli_writes_trajectory_and_debug_meshes(tmp_path):
    """``python -m hive_tpu_torch.pose_optimisation <dataset>`` with a
    cached feature set: the optimised trajectory, a plot per step when
    matplotlib is present, and the before/after debug meshes. The CLI fuses
    them at an 80M-voxel budget, which on a CPU shared with other test
    workers takes minutes; here the budget is 500,000."""
    import hive_tpu_torch.fusion  # noqa: F401 (its defaults built before the patch)
    from hive_tpu_torch import options as port_options
    from hive_tpu_torch.meshing.ply import load_ply

    path = make_synthetic_hive_dataset(tmp_path / "ds", num_frames=6)
    debug = write_feature_cache(path, 6, _SyntheticProblem(num_frames=6))
    with open(os.path.join(debug, "feature_options.json")) as f:
        fingerprint = f.read()
    # The CLI extracts with min_features=40: rewrite the fingerprint hive_tpu
    # would write for those options.
    with open(os.path.join(debug, "feature_options.json"), "w") as f:
        f.write(fingerprint.replace('"min_features": 20', '"min_features": 40'))
    mesh_options = port_options.BackgroundMeshOptions
    with mock.patch.object(port_options, "BackgroundMeshOptions",
                           lambda sdf_max_voxels: mesh_options(sdf_max_voxels=500_000)):
        P.main([path, "--num_frames", "5"], device="cpu")
    files = set(os.listdir(debug))
    assert {"before.ply", "after.ply", "optimised_camera_trajectory.txt",
            "initial_trajectory.png", "1_PairWise3D.png", "2_Global3D.png"} <= files
    for name in ("before.ply", "after.ply"):
        mesh = load_ply(os.path.join(debug, name))
        assert len(mesh.faces) > 100 and np.isfinite(mesh.vertices).all()
    assert len(np.loadtxt(os.path.join(debug, "optimised_camera_trajectory.txt"))) == 5


# ---------------------------------------------------------------------------
# Foreground trajectory smoothing through the pipelines.
# ---------------------------------------------------------------------------

def test_fts_flag_rejected_by_hive_tpu_cli_accepted_here(tmp_path):
    """hive_tpu's parser leaves out the ForegroundTrajectorySmoothingOptions
    group (a reference fault: its pipeline reads fts_options, which only its
    constructor sets); the port's CLI takes --fts_num_epochs."""
    from hive_tpu.pipeline import Pipeline as JaxPipeline
    from hive_tpu_torch.pipeline import Pipeline

    argv = ["--dataset_path", "x", "--output_path", "y", "--fts_num_epochs", "5",
            "--fts_learning_rate", "1e-4", "--log_file", str(tmp_path / "log.txt")]
    with mock.patch.object(sys, "argv", ["hive", *argv]), pytest.raises(SystemExit):
        JaxPipeline.from_command_line()
    pipeline = Pipeline.from_command_line(argv, device="cpu")
    assert (pipeline.fts_options.num_epochs, pipeline.fts_options.learning_rate) == (5, 1e-4)


def test_fts_cli_meshes_match(tmp_path):
    """``--fts_num_epochs 5`` on a HIVE dataset with a moving blob: the
    stages run one after the other (stages_overlapped false in both
    profiling.json files), the foreground is meshed with the smoothed
    trajectory (the dataset's own is restored for the background), fg.glb's
    faces equal hive_tpu's and its vertices within 1e-5; bg.glb equal. The
    smoothed poses differ by float32 rounding, which the QEM decimator's
    discrete choices would turn into other faces, so the frames' meshes stay
    under --num_faces_object here."""
    from hive_tpu.options import ForegroundTrajectorySmoothingOptions as JaxFTS
    from hive_tpu.pipeline import Pipeline as JaxPipeline
    from hive_tpu_torch.meshing.gltf import load_glb
    from hive_tpu_torch.pipeline import Pipeline

    base = make_synthetic_hive_dataset(tmp_path / "base", num_frames=6)
    scenes, profiling = {}, {}
    for name in ("jax", "torch"):
        path = str(tmp_path / name)
        shutil.copytree(base, path)
        argv = ["--dataset_path", path, "--output_path", path, "--num_frames", "6",
                "--key_frame_threshold", "1.0", "--overwrite_ok", "--sdf_max_voxels", "500000",
                "--num_faces_object", "8192", "--webxr_path", path + "_webxr",
                "--log_file", path + ".log"]
        if name == "jax":
            with mock.patch.object(sys, "argv", ["hive", *argv]):
                pipeline = JaxPipeline.from_command_line()
            pipeline.fts_options = JaxFTS(num_epochs=5)
            pipeline.run(compress=False)
        else:
            Pipeline.from_command_line(argv + ["--fts_num_epochs", "5"],
                                       device="cpu").run(compress=False)
        with open(os.path.join(path, "profiling.json")) as f:
            profiling[name] = json.load(f)
        scenes[name] = {part: load_glb(os.path.join(path, "mesh", f"{part}.glb"))
                        for part in ("fg", "bg")}
        np.testing.assert_array_equal(HiveDataset(path).camera_trajectory.values,
                                      HiveDataset(base).camera_trajectory.values)
    assert profiling["torch"]["timing"]["stages_overlapped"] is False
    assert profiling["jax"]["timing"]["stages_overlapped"] is False
    ours, theirs = scenes["torch"]["fg"], scenes["jax"]["fg"]
    assert ours.node_names == theirs.node_names and len(ours.node_names) == 6
    for node in ours.node_names:
        got, want = ours.geometry[node], theirs.geometry[node]
        np.testing.assert_array_equal(got.faces, want.faces)
        np.testing.assert_allclose(got.vertices, want.vertices, rtol=0, atol=1e-5)
    for attribute in ("faces", "vertices"):
        np.testing.assert_array_equal(
            getattr(next(iter(scenes["torch"]["bg"].geometry.values())), attribute),
            getattr(next(iter(scenes["jax"]["bg"].geometry.values())), attribute))
