"""The op counts the rooflines divide by, against hand sums of the
published NeRF layers (8 x 256 trunk, skip into layer 6, 63 position and
27 direction features, a 128-wide head)."""

from nerfbench import flops, harness

LEGO = harness.load("configs", "nerf-blender-lego")


def test_forward_macs_are_the_layers():
    by_hand = (63 * 256              # l1
               + 4 * 256 * 256       # l2 .. l5
               + (256 + 63) * 256    # l6, the skip
               + 2 * 256 * 256       # l7, l8
               + 256 * 1             # the density head
               + 256 * 256           # l9, the feature layer
               + (256 + 27) * 128    # l10, with the directions
               + 128 * 3)            # l11, rgb
    assert by_hand == 593_408
    assert flops.forward_macs(LEGO) == by_hand
    assert flops.forward_ops(LEGO) == 1_186_816


def test_backward_is_weight_and_input_gradients():
    # Weight gradients: one multiply-add a weight; input gradients: every
    # layer's but those into fixed encodings (l1, l6's 63 rows, l10's 27).
    by_hand = 2 * (593_408 + 593_408 - 63 * 256 - 63 * 256 - 27 * 128)
    assert by_hand == 2_302_208
    assert flops.backward_ops(LEGO) == by_hand


def test_step_and_frame_work():
    assert flops.points_per_ray(LEGO) == 64 + 64 + 128
    assert flops.step_ops(LEGO) == 1024 * 256 * (1_186_816 + 2_302_208)
    assert abs(flops.step_ops(LEGO) - 9.146e11) < 1e8
    assert flops.frame_ops(LEGO) == 400 * 400 * 256 * 1_186_816


def test_published_peaks():
    assert flops.PEAKS["bf16"] == 989e12
    assert flops.PEAKS["fp32"] == 67e12
    assert flops.PEAKS["int8"] == 1979e12
    assert flops.PEAKS["hbm_bytes_per_s"] == 3.35e12
    assert isinstance(flops.power_limit(), str)
