"""The control of a cell: the same run as ``run.py``, with the plain
reference at a lower precision (every witness value or coefficient cut
to its low 128 bits: half of the field's width) in the program's place.
Its answers have to come out as not correct; the benchmark's own runs
never run it.

    python3 portbench/control.py --workload <name> --seed <n> \
        --seconds <s>
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

from portbench import run  # noqa: E402

if __name__ == "__main__":
    sys.exit(run.main(serve="control"))
