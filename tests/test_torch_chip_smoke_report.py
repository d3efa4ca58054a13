"""`chip_smoke.py`'s reading of nvcc's ptxas report, on a log shaped like nvcc's.

ptxas prints its warning that it serialized an entry's wgmma before the
entries' own lines, naming the function; the report must attach it to that
entry so that the smoke run fails on it.
"""

import chip_smoke

LOG = """\
ptxas info    : (C7520) Potential Performance Loss: wgmma.mma_async instructions are serialized due to \
program dependence on compiler-inserted WG.AR in divergent path in the function '_Z4wideILi2EEvv'
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z5wgmmaILi64EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z5wgmmaILi64EEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z4wideILi2EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z4wideILi2EEvv
    176 bytes stack frame, 176 bytes spill stores, 172 bytes spill loads
ptxas info    : Used 224 registers, used 16 barriers, 176 bytes cumulative stack size
"""


def test_ptxas_report_attaches_each_warning_to_its_entry():
    first, second = chip_smoke.ptxas_report(LOG)
    assert first == dict(entry="_Z5wgmmaILi64EEvv", spill_stores=0, spill_loads=0, registers=168)
    assert (second["entry"], second["spill_stores"], second["spill_loads"], second["registers"]) == (
        "_Z4wideILi2EEvv", 176, 172, 224)
    assert "serialized" in second["wgmma_serialized"]
