"""chip_smoke's tensor-core count on synthetic `cuobjdump -sass` listings:
mma.sync (HMMA) and wgmma (HGMMA) instructions counted apart, and the
build phase's check that every backward product kernel, the general flash
forward and the general SSD scan and backward product kernels issue one of
them and every wide backward kernel issues HGMMA."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def _function(name, *instructions):
    body = "".join(f"        /*{16 * i:04x}*/    {ins} ;  /* 0x0 */\n"
                   for i, ins in enumerate(instructions))
    return f"\n\tFunction : {name}\n\t.headerflags\t@\"EF_CUDA_SM90\"\n{body}"


MMA = "HMMA.16816.F32.BF16 R8, R20, R24, R8"
WGMMA = "HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT"
PLAIN = "FFMA R2, R3, R4, R2"
# every group of chip_smoke.TENSOR_CORE_CHECKS, each kernel as it should be
SOUND = {
    "_Z13ssd_cb_kernelIfEvv": (MMA, PLAIN),
    "_Z15ssd_scan_kernelIfEvv": (MMA,),
    "_Z14flash_bwd_dkdvIfLi72ELb1EEvv": (MMA, MMA, PLAIN),
    "_Z12flash_bwd_dqIfLi72ELb1EEvv": (MMA,),
    "_Z18flash_bwd_dkdv_anyIfLb1EEvv": (MMA,),
    "_Z19flash_bwd_dkdv_wideILi160ELi160EEvv": (WGMMA, WGMMA, PLAIN),
    "_Z17flash_bwd_dq_wideILi160ELi160EEvv": (WGMMA,),
    "_Z20ssd_bwd_state_kernelIfEvv": (MMA,),
    "_Z19ssd_bwd_tile_kernelIfEvv": (MMA,),
    "_Z9flash_fwdIfLi72ELb1EEvv": (MMA,),
    "_Z13flash_fwd_anyIfLb1ELb0EEvv": (MMA, MMA, PLAIN),
    "_Z10ssd_cb_anyIfLb1EEvv": (MMA,),
    "_Z12ssd_scan_anyIfLb1ELb1EEvv": (MMA, PLAIN),
    "_Z17ssd_bwd_state_anyIfLb1EEvv": (MMA,),
    "_Z16ssd_bwd_tile_anyIfLb1EEvv": (MMA, PLAIN),
    # the general backward's tile scans: no product, in no group
    "_Z16ssd_bwd_scan_anyEvv": (PLAIN,),
}


def _listing(kernels):
    return "".join(_function(n, *ins) for n, ins in kernels.items())


def test_counts_hmma_and_hgmma_apart():
    counts = chip_smoke.tensor_core_counts(_listing(SOUND))
    assert counts["_Z14flash_bwd_dkdvIfLi72ELb1EEvv"] == {"HMMA": 2,
                                                          "HGMMA": 0}
    assert counts["_Z19flash_bwd_dkdv_wideILi160ELi160EEvv"] == {
        "HMMA": 0, "HGMMA": 2}
    assert counts["_Z17flash_bwd_dq_wideILi160ELi160EEvv"] == {"HMMA": 0,
                                                               "HGMMA": 1}
    assert len(counts) == len(SOUND)
    lines, failures = chip_smoke.check_tensor_cores(counts)
    assert failures == []
    assert len(lines) == len(chip_smoke.TENSOR_CORE_CHECKS)
    assert any("2 of 2 wide flash backward kernels issue HGMMA; HMMA 0, "
               "HGMMA 3" in line for line in lines)


@pytest.mark.parametrize("name,instructions,fragment", [
    # a backward product kernel with neither instruction
    ("_Z12flash_bwd_dqIfLi72ELb1EEvv", (PLAIN,), "flash backward kernel"),
    ("_Z16flash_bwd_dq_anyIfLb1EEvv", (PLAIN, PLAIN), "flash backward"),
    # a wide backward kernel on mma.sync only: no wgmma
    ("_Z19flash_bwd_dkdv_wideILi160ELi160EEvv", (MMA,),
     "wide flash backward kernel"),
    ("_Z20ssd_bwd_state_kernelIfEvv", (PLAIN,), "SSD backward kernel"),
    # a general flash forward without tensor-core products
    ("_Z13flash_fwd_anyIfLb1ELb0EEvv", (PLAIN,),
     "general flash forward kernel"),
    # a general SSD scan or backward tile kernel without them
    ("_Z12ssd_scan_anyIfLb1ELb1EEvv", (PLAIN, PLAIN),
     "general SSD forward kernel"),
    ("_Z16ssd_bwd_tile_anyIfLb1EEvv", (PLAIN,),
     "general SSD backward kernel"),
])
def test_a_kernel_without_its_instructions_fails(name, instructions,
                                                 fragment):
    kernels = dict(SOUND, **{name: instructions})
    _, failures = chip_smoke.check_tensor_cores(
        chip_smoke.tensor_core_counts(_listing(kernels)))
    assert len(failures) == 1
    assert fragment in failures[0] and name in failures[0]


def test_a_missing_group_fails():
    kernels = {n: i for n, i in SOUND.items() if "_wide" not in n}
    _, failures = chip_smoke.check_tensor_cores(
        chip_smoke.tensor_core_counts(_listing(kernels)))
    assert failures == ["no wide flash backward kernel in the SASS"]
