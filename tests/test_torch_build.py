"""The kernel build helper's reading of ptxas's register and spill report
(`repro_torch.kernels._build.ptxas_usage`), on a report in the form
``nvcc -Xptxas -v`` prints it. Runs without nvcc."""
from repro_torch.kernels import _build

REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z19fused_snn_net_gated7NetArgs' for 'sm_90a'
ptxas info    : Function properties for _Z19fused_snn_net_gated7NetArgs
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 1536 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111wkv6_kernelILi64ELi32EEEvPKfS2_S2_S2_S2_S2_PfS3_ii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_111wkv6_kernelILi64ELi32EEEvPKfS2_S2_S2_S2_S2_PfS3_ii
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 416 bytes cmem[0]
"""


def test_ptxas_usage_reads_every_entry():
    usage = _build.ptxas_usage(REPORT)
    assert usage["_Z19fused_snn_net_gated7NetArgs"] == {
        "registers": 40, "spill_stores": 0, "spill_loads": 0}
    wkv = [k for k in usage if "wkv6_kernelILi64ELi32E" in k]
    assert len(usage) == 2 and len(wkv) == 1
    assert usage[wkv[0]] == {"registers": 96, "spill_stores": 12,
                             "spill_loads": 16}


def test_ptxas_usage_of_an_empty_report():
    assert _build.ptxas_usage("") == {}
    assert _build.ptxas_usage("ptxas info    : Used 9 registers") == {}


def test_build_flags_ask_ptxas_for_its_report():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "-Xptxas -v" in flags
    assert "arch=compute_90a,code=sm_90a" in flags
