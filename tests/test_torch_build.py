"""ops/_build.py's reading of ptxas' report: parses text, builds nothing,
so it runs on the CPU."""

from ray_tpu_torch.ops import _build

# kernels in an anonymous namespace, mangled as nvcc 12.9 and g++ do
_FWD = ("_ZN45_GLOBAL__N__051b5154_12_flash_fwd_cu_b294bfd021"
        "flash_fwd_sm90_kernelILi64EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16"
        "Pfiiif")
_F32 = "_ZN12_GLOBAL__N_120flash_fwd_f32_kernelILi128EEEvPKfS2_S2_PfS3_iiiif"

# nvcc -Xptxas -v output of the form CUDA 12 prints, shortened
_LOG = f"""ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{_FWD}' for 'sm_90a'
ptxas info    : Function properties for {_FWD}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 400 bytes cmem[0]
ptxas /tmp/tmpxft_0001-6.ptx, line 904; warning : setmaxnreg ignored; unable to determine register count at entry
ptxas info    : Compiling entry function '{_F32}' for 'sm_90a'
ptxas info    : Function properties for {_F32}
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 40 registers, 13568 bytes smem, 400 bytes cmem[0]
"""


def test_ptxas_report_reads_each_kernel():
    rep = _build.ptxas_report(_LOG)
    assert rep == [
        {"kernel": "flash_fwd_sm90_kernel<64>", "registers": 168,
         "smem_bytes": 0, "stack_bytes": 0, "spill_stores": 0,
         "spill_loads": 0,
         "warnings": ["ptxas /tmp/tmpxft_0001-6.ptx, line 904; warning : "
                      "setmaxnreg ignored; unable to determine register "
                      "count at entry"]},
        {"kernel": "flash_fwd_f32_kernel<128>", "registers": 40,
         "smem_bytes": 13568, "stack_bytes": 8, "spill_stores": 4,
         "spill_loads": 12, "warnings": []},
    ]


def test_ptxas_report_of_an_empty_log_is_empty():
    assert _build.ptxas_report("") == []


def test_kernel_mutants_edit_lines_occur_once():
    """Each mutant of kernel_mutants.py edits lines that occur exactly once
    in the checkout's source (a kernel under csrc/, or parallel/ring.py),
    so it builds what it names."""
    from pathlib import Path

    import kernel_mutants

    pkg = Path(kernel_mutants._ROOT) / "ray_tpu_torch"
    for name, (source, edits, checks) in kernel_mutants.MUTANTS.items():
        text = (pkg / source).read_text()
        for old, new in edits:
            assert text.count(old) == 1, (name, old)
            assert old != new
        assert set(checks) <= set(kernel_mutants.CHECKS), name
