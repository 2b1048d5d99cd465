"""The TinyRAM demos' file contracts (reference operator>> formats):
  architecture_params: "<w> <k>"
  computation_bounds:  "<input_size_bound> <program_size_bound> <time_bound>"
  processed_assembly:  records "opcode immflag des arg1 arg2"
  primary/auxiliary_input: "<n> <word>*n"
and the split demos' program file, one instruction a line:
  OPCODE imm des arg1 arg2   (# starts a comment)
"""
from __future__ import annotations

import argparse
import os
import tempfile

RAM_FILE_OPTIONS = ("assembly", "processed_assembly", "architecture_params",
                    "computation_bounds", "primary_input", "auxiliary_input")

DEFAULT_PROGRAM = """\
MOV 1 0 0 7
STOREW 1 0 0 64
LOADW 1 1 0 64
ANSWER 1 0 0 0
"""


def default_dir() -> str:
    """The split demos' directory when none is given."""
    return os.path.join(tempfile.gettempdir(), "ram_demo")


def read_tape(path):
    toks = open(path).read().split()
    n = int(toks[0])
    return [int(t) for t in toks[1:1 + n]]


def load_program(path):
    from ..relations.tinyram import Opcode, TinyRAMProgram
    prog = TinyRAMProgram()
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            op, imm, des, a1, a2 = line.split()
            prog.add(Opcode[op], imm in ("1", "true", "imm"),
                     int(des), int(a1), int(a2))
    return prog


def parse_ram_files(argv):
    """The six required ``--<name> <file>`` options and ``--device``."""
    ap = argparse.ArgumentParser()
    for name in RAM_FILE_OPTIONS:
        ap.add_argument("--" + name, required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def read_ram_files(args):
    """(TinyRAMParams, (input_size_bound, program_size_bound, time_bound),
    program, primary tape, auxiliary tape) from the parsed options."""
    from ..relations.tinyram import TinyRAMParams, load_preprocessed_program
    w, k = (int(t) for t in open(args.architecture_params).read().split()[:2])
    ap = TinyRAMParams(w=w, k=k)
    bounds = tuple(int(t) for t in
                   open(args.computation_bounds).read().split()[:3])
    with open(args.processed_assembly) as f:
        program = load_preprocessed_program(ap, f)
    return (ap, bounds, program, read_tape(args.primary_input),
            read_tape(args.auxiliary_input))
