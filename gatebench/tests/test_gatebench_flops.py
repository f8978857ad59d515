"""``gatebench.flops`` against counts worked out by hand."""

import pytest

from gatebench import flops


def test_superpoint_at_the_detect_resolutions():
    # 264 x 360 (crica_lg512's 270 x 360 cut to multiples of 8), 2 k^2 cin cout h w a conv:
    # stage 1 at 95,040 px: 2*9*1*64 + 2*9*64*64 -> 109,486,080 + 7,007,109,120
    # stage 2 at 23,760 px: 2 x 1,751,777,280; stage 3 at 5,940: 875,888,640 + 1,751,777,280
    # stage 4 at 1,485: 2 x 437,944,320; heads: 875,888,640 + 49,420,800 + 875,888,640 + 194,641,920
    assert flops.superpoint(264, 360) == 16_119_544_320
    assert flops.superpoint(536, 720) == 65_455_119_360


@pytest.mark.parametrize("n, expected", [
    # N = 1024 tokens: in_proj 2*1024*256^2 = 134,217,728; each of 9 layers
    # 40*N*D^2 = 2,684,354,560 of projections and MLPs plus attention
    # 4*D*(2*512^2) + 8*D*512^2 = 1,073,741,824; final_proj 134,217,728;
    # similarity 2*512*512*256 = 134,217,728; matchability 2*1024*256 = 524,288
    (512, 34_226_044_928),
    # N = 4096: 536,870,912 + 9 * (10,737,418,240 + 17,179,869,184) + 536,870,912
    # + 2,147,483,648 + 2,097,152
    (2048, 254_478_909_440),
])
def test_lightglue_at_the_matched_counts(n, expected):
    assert flops.lightglue(n, n) == expected


def test_lightglue_counts_valid_keypoints_only():
    assert flops.lightglue(300, 200) == 14_262_528_000
    assert flops.lightglue(300, 200) == flops.lightglue(200, 300)


def test_vit_b14_at_322():
    # 530 tokens: patch embedding 2*588*768*529 = 477,775,872; each of 12 blocks
    # qkv 2*530*768*2304 + attention 4*530^2*768 + proj 2*530*768^2
    # + MLP 4*530*768*3072 = 8,365,486,080
    assert flops.vit(322, 322) == 477_775_872 + 12 * 8_365_486_080


def test_resnet50_to_stage3_and_mixvpr_at_320():
    # stem 481,689,600; layer1 2,726,297,600; layer2 4,194,304,000; layer3 5,976,883,200
    assert flops.resnet50_stage3(320, 320) == 13_379_174_400
    # mixer 4*4*1024*400^2 + channel projection 2*400*1024^2 + rows 2*1024*400*4
    assert flops.mixvpr(320, 320, 4096) == 13_379_174_400 + 3_463_577_600


def test_attention_kernel_work_and_bound():
    ops, nbytes = flops.vit_attention(530)
    assert (ops, nbytes) == (4 * 530 * 530 * 768, 4 * 530 * 768 * 2)
    t, by = flops.bound_s(ops, nbytes)
    assert by == "bytes" and t == pytest.approx(nbytes / 3.35e12)
    ops, nbytes = flops.lightglue_attention(2048, 2048)
    assert (ops, nbytes) == (17_179_869_184, 16_777_216)
    assert flops.bound_s(ops, nbytes)[1] == "operations"
