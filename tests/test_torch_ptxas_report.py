"""tools/ptxas_report.py's parsing of ptxas's `-v` output and of cuobjdump's
SASS, on excerpts in the form the CUDA 12.8 toolkit prints them (the tool
itself needs nvcc and runs on the machine with the card)."""
from megatron_tpu_torch.tools import ptxas_report

K1 = "_ZN12_GLOBAL__N_126flash_bwd_dkv_wgmma_kernelILi128ELi32ELb0EEEvNS_6ParamsE"
K2 = "_ZN12_GLOBAL__N_123flash_bwd_dq_fma_kernelILi64ELb0EEEvNS_6ParamsE"

PTXAS = f"""\
ptxas info    : 0 bytes gmem
ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async \
instructions are serialized due to insufficient register resources for the \
function '{K1}'
ptxas info    : Compiling entry function '{K1}' for 'sm_90a'
ptxas info    : Function properties for {K1}
    480 bytes stack frame, 612 bytes spill stores, 648 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers, 480 bytes cumulative \
stack size
ptxas info    : Compiling entry function '{K2}' for 'sm_90a'
ptxas info    : Function properties for {K2}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 100 registers, used 1 barriers
"""

SASS = f"""
        code for sm_90a
                Function : {K1}
        /*0010*/                   STL [R1+0x94], R0 ;
        /*0cb0*/                   USETMAXREG.DEALLOC.CTAPOOL 0x20 ;
        /*0cc0*/                   LDL R2, [R1+0x94] ;
        /*0d00*/                   USETMAXREG.TRY_ALLOC.CTAPOOL UP0, 0xe8 ;
        /*1920*/                   STL.64 [R1+0xd0], R38 ;
        /*1930*/                   LDL.LU.64 R38, [R1+0xd0] ;
        /*1940*/                   HGMMA.64x32x16.F32.BF16 R24, gdesc[UR20], R183 ;
                Function : {K2}
        /*0010*/                   FFMA R3, R2, R101, R3 ;
"""


def test_parse_ptxas_reads_spills_registers_and_serialization():
    got = ptxas_report.parse_ptxas(PTXAS)
    assert got[K1] == dict(registers=168, spill_stores=612, spill_loads=648,
                           serialized=got[K1]["serialized"])
    assert got[K1]["serialized"].startswith("C7512 Potential Performance")
    assert got[K2] == dict(registers=100, spill_stores=0, spill_loads=0,
                           serialized=None)


def test_parse_sass_counts_local_traffic_by_setmaxnreg_region():
    got = ptxas_report.parse_sass(SASS)
    assert got[K1] == dict(max_register=183,
                           local={"entry": 1, "producer": 1, "consumer": 2})
    assert got[K2] == dict(max_register=101, local={})
