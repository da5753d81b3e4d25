"""RenderConfig.accel: one compiled traversal path ("bvh") and the brute
oracle; "pallas" is gone."""

import pytest

from raytracer_tpu.utils.config import RenderConfig


def test_pallas_accel_is_rejected():
    with pytest.raises(ValueError, match="unknown accel"):
        RenderConfig(accel="pallas")


def test_auto_resolves_to_bvh():
    assert RenderConfig().resolve_accel().accel == "bvh"
    assert RenderConfig(accel="brute").resolve_accel().accel == "brute"


def test_cli_rejects_pallas_accel():
    from raytracer_tpu.cli import build_parser

    with pytest.raises(SystemExit):
        build_parser().parse_args(["scene.json", "--accel", "pallas"])
    args = build_parser().parse_args(["scene.json"])
    assert args.accel == "auto"
