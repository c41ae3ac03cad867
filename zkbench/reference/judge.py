"""The comparison that decides `correct`.

Every proof the timed window produced is judged by the reference, which
shares no code with the program and takes only the guest's ELF:

- `io`: the guest's outputs, panic bit and padded trace length, as the
  reference's own interpreter (rv64.py) runs the ELF, against what the prove
  reported;
- `rejected`: the reference verifier (verify.check) refuses the proof
  against the reference's public I/O;
- `claims`: a proof the verifier took whose claims about the execution
  (verify.execution_claims) differ from the reference's run.

Each number counts proofs, and its limit is 0: the comparison is exact.
"""

from __future__ import annotations

from . import rv64, verify

LIMITS = {"raised": 0, "io": 0, "rejected": 0, "claims": 0}


def judge(proofs: list[dict], elf_path_of, config: dict,
          seed: int) -> tuple[dict, list[str], set[int]]:
    """The checks over the window's proofs (dicts with index, blob, outputs,
    panic, trace_length; blob None where the prove raised), each a count with
    its limit; notes on what failed; the indices of the proofs that failed.
    `elf_path_of(index)` writes the index-th guest again for the
    reference."""
    counts = dict.fromkeys(LIMITS, 0)
    notes, bad = [], set()
    for p in proofs:
        if p["blob"] is None:
            counts["raised"] += 1
            bad.add(p["index"])
            continue
        with open(elf_path_of(p["index"]), "rb") as f:
            run = rv64.run(f.read())
        want = (run.outputs, run.panic, run.padded_length)
        got = (p["outputs"], p["panic"], p["trace_length"])
        if got != want:
            counts["io"] += 1
            bad.add(p["index"])
            notes.append(f"proof {p['index']}: io {got!r} != {want!r}")
        try:
            checked = verify.check(
                p["blob"], outputs=run.outputs, panic=run.panic,
                memory_size=config["memory_size"],
                log_ram_k=config["log_ram_k"], trace_length=run.padded_length)
        except verify.Reject as e:
            counts["rejected"] += 1
            bad.add(p["index"])
            notes.append(f"proof {p['index']}: rejected: {e}")
            continue
        differ = verify.execution_claims(checked, run, config["log_ram_k"])
        if differ:
            counts["claims"] += 1
            bad.add(p["index"])
            notes.append(f"proof {p['index']}: claims differ: {differ}")
    checks = {name: {"value": counts[name], "limit": LIMITS[name]}
              for name in LIMITS}
    return checks, notes, bad


def is_correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
