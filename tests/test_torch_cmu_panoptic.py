"""hive_tpu_torch's CMU Panoptic (Kinoptic) loader against hive_tpu's on
the CPU.

Two captures: tests/test_cmu_panoptic.py's ``capture`` (node 1, constant
32x32 JPEGs, a dropped colour frame) and ``textured_capture`` below (two
nodes, seeded textured 4:2:0 JPEGs at an odd size, one node's JPEGs grey,
random depth, calibrations with real rotations, drifting sync tables with
a dropped frame). Held, without tolerance:

- every parsed sync table and calibration: arrays and dtypes equal;
- synced pairs: the colour frame equal (the port's libjpeg-turbo ISLOW
  decode with fancy upsampling, cv2's ``imread`` + BGR -> RGB in
  hive_tpu), the depth map equal in value and dtype (float64);
- ``kinect_to_world_coordinates`` bit-equal;
- the gap, distance and node refusals raise the same errors.
"""

import json
import os

import cv2
import numpy as np
import pytest

from hive_tpu import dataset as jax_dataset
from hive_tpu_torch import dataset
from tests.test_cmu_panoptic import capture  # noqa: F401 (a fixture)

SIZE = (45, 67)  # (height, width): odd, so the chroma edges are upsampled too
HD_FRAMES = 6
NODES = (2, 7)
GREY_NODE = 7


def _rotation(rng):
    q = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    return q if np.linalg.det(q) > 0 else -q


@pytest.fixture()
def textured_capture(tmp_path):
    name = "textured"
    base = tmp_path / name
    os.makedirs(base)
    rng = np.random.default_rng(15)

    hd_times = (1000.0 + 33.3667 * np.arange(HD_FRAMES)).tolist()
    with open(base / f"synctables_{name}.json", "w") as fh:
        json.dump({"vga": {"index": [0, 1], "univ_time": [1000.0, 1040.0]},
                   "hd": {"index": list(range(HD_FRAMES)), "univ_time": hd_times}}, fh)

    # Each node's colour stream drifts (+6.25 ms plus a slow skew) and drops
    # one frame; its depth stream sits ~3 ms after the HD clock.
    ksync = {"kinect": {"color": {}, "depth": {}}}
    streams = {}
    for node in NODES:
        numbers = [k + 1 for k in range(HD_FRAMES + 1) if k != node % HD_FRAMES]
        color_times = [1000.0 + 33.3667 * (n - 1) + 6.25 + 0.1 * (n - 1) for n in numbers]
        depth_times = [1000.0 + 33.3667 * k + 3.0 + 0.05 * k for k in range(HD_FRAMES)]
        ksync["kinect"]["color"][f"KINECTNODE{node}"] = {"index": numbers,
                                                         "univ_time": color_times}
        ksync["kinect"]["depth"][f"KINECTNODE{node}"] = {"index": list(range(HD_FRAMES)),
                                                         "univ_time": depth_times}
        streams[node] = numbers
    with open(base / f"ksynctables_{name}.json", "w") as fh:
        json.dump(ksync, fh)

    cameras, sensors = [], []
    for node in range(1, 11):
        K = [[900 + node, 0, 960.5], [0, 901 - node, 540.25], [0, 0, 1]]
        cameras.append({"name": f"50_{node:02d}", "type": "kinect-color",
                        "resolution": [1920, 1080], "panel": 50, "node": node, "K": K,
                        "distCoef": rng.normal(0, 0.01, 5).tolist(),
                        "R": _rotation(rng).tolist(), "t": rng.normal(0, 100, (3, 1)).tolist()})
        M_color = np.eye(4)
        M_color[:3, :3] = _rotation(rng)
        M_color[:3, 3] = rng.normal(0, 0.05, 3)
        sensors.append({
            "K_depth": rng.normal(size=(3, 3)).tolist(), "M_depth": rng.normal(size=(4, 4)).tolist(),
            "distCoeffs_depth": rng.normal(0, 0.01, 5).tolist(),
            "depth_width": 512, "depth_height": 424, "K_color": K, "M_color": M_color.tolist(),
            "distCoeffs_color": rng.normal(0, 0.01, 5).tolist(),
            "color_width": 1920, "color_height": 1080,
            "color_time_offset": int(rng.integers(-5, 5)),
            "depth_time_offset": int(rng.integers(-5, 5)),
            "M_world2sensor": rng.normal(size=(4, 4)).tolist(),
            "domeCenter": rng.normal(size=(3, 1)).tolist()})
    with open(base / f"calibration_{name}.json", "w") as fh:
        json.dump({"calibDataSource": "synthetic", "cameras": cameras}, fh)
    with open(base / f"kcalibration_{name}.json", "w") as fh:
        json.dump({"calibDataSource": "synthetic", "panopticCalibDataSource": "synthetic",
                   "M_world2vga": rng.normal(size=(4, 4)).tolist(), "sensors": sensors}, fh)

    h, w = dataset.CMUPanopticDataset.depth_frame_height, dataset.CMUPanopticDataset.depth_frame_width
    for node in NODES:
        image_dir = base / "kinectImgs" / f"50_{node:02d}"
        os.makedirs(image_dir)
        for number in streams[node]:
            texture = cv2.GaussianBlur(rng.integers(0, 256, (*SIZE, 3)).astype(np.uint8),
                                       (3, 3), 0.8)
            if node == GREY_NODE:
                texture = texture[..., 0]
            # cv2 writes colour JPEGs with 4:2:0 chroma.
            cv2.imwrite(str(image_dir / f"50_{node:02d}_{number:08d}.jpg"), texture)
        depth_dir = base / "kinect_shared_depth" / f"KINECTNODE{node}"
        os.makedirs(depth_dir)
        with open(depth_dir / "depthdata.dat", "wb") as fh:
            fh.write(rng.integers(0, 8000, (HD_FRAMES, h, w)).astype("<u2").tobytes())

    return str(base)


def _assert_same_attributes(got, want):
    got_vars, want_vars = vars(got), vars(want)
    assert set(got_vars) == set(want_vars)
    for key, value in want_vars.items():
        if isinstance(value, np.ndarray):
            assert got_vars[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got_vars[key], value, err_msg=key)
        else:
            assert got_vars[key] == value, key


CAPTURES = ["capture", "textured_capture"]


@pytest.mark.parametrize("name", CAPTURES)
def test_tables_and_calibrations_match_hive_tpu(name, request):
    path = request.getfixturevalue(name)
    got, want = dataset.CMUPanopticDataset(path), jax_dataset.CMUPanopticDataset(path)
    assert got.dataset_name == want.dataset_name
    for stream in ("vga", "hd"):
        _assert_same_attributes(getattr(got.sync_table, stream), getattr(want.sync_table, stream))
    for kind in ("color", "depth"):
        got_streams = getattr(got.kinect_sync_table, kind)
        want_streams = getattr(want.kinect_sync_table, kind)
        assert list(got_streams) == list(want_streams)
        for node_name in want_streams:
            _assert_same_attributes(got_streams[node_name], want_streams[node_name])
    assert got.camera_calibration.calib_data_source == want.camera_calibration.calib_data_source
    assert list(got.camera_calibration.cameras) == list(want.camera_calibration.cameras)
    for camera in want.camera_calibration.cameras:
        _assert_same_attributes(got.camera_calibration[camera], want.camera_calibration[camera])
    kinect_got, kinect_want = got.kinect_calibration, want.kinect_calibration
    assert (kinect_got.calib_data_source, kinect_got.panoptic_calib_data_source,
            kinect_got.M_world2vga) == (kinect_want.calib_data_source,
                                        kinect_want.panoptic_calib_data_source,
                                        kinect_want.M_world2vga)
    assert list(kinect_got.sensors) == list(kinect_want.sensors)
    for node in kinect_want.sensors:
        _assert_same_attributes(kinect_got[node], kinect_want[node])
    for attr in ("depth_to_meters", "depth_frame_width", "depth_frame_height", "depth_dtype",
                 "MAX_DEPTH_COLOR_GAP_MS", "MAX_COLOR_DISTANCE_MS", "MAX_DEPTH_DISTANCE_MS",
                 "depth_parent_folder", "depth_filename", "image_folder"):
        assert getattr(got, attr) == getattr(want, attr), attr


def _outcome(fn, *args):
    try:
        return fn(*args)
    except RuntimeError as exc:
        return exc


@pytest.mark.parametrize("name", CAPTURES)
def test_synced_pairs_and_transforms_match_hive_tpu(name, request):
    path = request.getfixturevalue(name)
    got, want = dataset.CMUPanopticDataset(path), jax_dataset.CMUPanopticDataset(path)
    nodes = [int(n.removeprefix("KINECTNODE")) for n in want.kinect_sync_table.color]
    pairs = 0
    for node in nodes:
        for frame in range(len(want.sync_table.hd.index)):
            expected = _outcome(want.get_synced_frame_data, frame, node)
            actual = _outcome(got.get_synced_frame_data, frame, node)
            if isinstance(expected, RuntimeError):
                assert type(actual) is type(expected) and str(actual) == str(expected)
                continue
            (image, depth), (want_image, want_depth) = actual, expected
            assert image.dtype == want_image.dtype == np.uint8
            np.testing.assert_array_equal(image, want_image)
            assert depth.dtype == want_depth.dtype == np.float64
            np.testing.assert_array_equal(depth, want_depth)
            pairs += 1
        transform = got.kinect_to_world_coordinates(node)
        want_transform = want.kinect_to_world_coordinates(node)
        assert transform.dtype == want_transform.dtype == np.float64
        assert transform.tobytes() == want_transform.tobytes()
    # The fixtures' sync tables leave most HD frames reachable.
    assert pairs >= 3


def test_textured_capture_selects_the_drifted_frames(textured_capture):
    """The colour frame is the stream's own number, the depth frame the
    depth stream's row: for HD frame 4, node 2's colour frame number 5 sits
    at row 3 of its stream, after the dropped frame 3."""
    got = dataset.CMUPanopticDataset(textured_capture)
    image, depth = got.get_synced_frame_data(frame_index=4, kinect_node=2)
    np.testing.assert_array_equal(image, got.get_image(2, 5))
    np.testing.assert_array_equal(depth, got.get_depth_map(2, 4))
    assert image.shape == (*SIZE, 3) and depth.shape == (424, 512)
    grey = got.get_image(GREY_NODE, 1)
    np.testing.assert_array_equal(grey[..., 0], grey[..., 2])


@pytest.mark.parametrize("fault", ["gap", "distance"])
def test_sync_refusals_match_hive_tpu(capture, fault):  # noqa: F811 (the fixture)
    got, want = dataset.CMUPanopticDataset(capture), jax_dataset.CMUPanopticDataset(capture)
    for loader in (got, want):
        if fault == "gap":
            table = loader.kinect_sync_table.depth["KINECTNODE1"]
            table.universal_time = table.universal_time + 50.0
        else:
            for table in (loader.kinect_sync_table.depth["KINECTNODE1"],
                          loader.kinect_sync_table.color["KINECTNODE1"]):
                table.universal_time = table.universal_time + 40.0
    with pytest.raises(RuntimeError) as want_error:
        want.get_synced_frame_data(frame_index=0, kinect_node=1)
    with pytest.raises(RuntimeError) as got_error:
        got.get_synced_frame_data(frame_index=0, kinect_node=1)
    assert str(got_error.value) == str(want_error.value)


@pytest.mark.parametrize("node", [0, 11])
def test_node_refusal_matches_hive_tpu(capture, node):  # noqa: F811 (the fixture)
    got, want = dataset.CMUPanopticDataset(capture), jax_dataset.CMUPanopticDataset(capture)
    for method, args in (("get_image_path", (node, 0)), ("get_depth_path", (node,)),
                         ("get_depth_map", (node, 0))):
        with pytest.raises(ValueError) as want_error:
            getattr(want, method)(*args)
        with pytest.raises(ValueError) as got_error:
            getattr(got, method)(*args)
        assert str(got_error.value) == str(want_error.value)
