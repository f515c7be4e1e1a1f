"""The certified RA-SLAM slice through the tiled path on the CPU: the
port's driver against the JAX package's on the 100-pose generated set
(5 robots x 20 poses), with FAST_PATH_MIN_POSES lowered in both packages
so the f32 and f64 tile phases and the block-tridiagonal preconditioner
run; every tile product goes through the strip layout's plain version.
Same rank, f* to 1e-8 relative, LDL^T witness (see
tests/test_torch_raslam_slice.py, which holds the check and the edge-path
case)."""

from test_torch_raslam_slice import check_slice, one_thread  # noqa: F401


def test_raslam_slice_tiled_path_matches_reference(tmp_path, monkeypatch):
    check_slice(tmp_path, monkeypatch, 20, "tiled")
