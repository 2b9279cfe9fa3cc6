"""Compare relaxation tables (.dat) of one run made by two trees.

    python3 compare_dat.py A.dat B.dat [A2.dat B2.dat ...]

For each pair it prints one JSON line: whether the data rows (the lines
not starting with '#') are byte-identical and, where they are not, the
largest relative difference of each column (of a ``--protocol samples``
table, rows N, sample, t, m, e[, m_y], each history's values and their
largest, ``values_rel``, and largest absolute change, ``values_abs``:
m_y of an ordered state is a sum that cancels to near 0, where a
last-bit change is a large relative one).  The means (<m>, <e>, <m²>,
<e²>) stand apart from the scaled variances (N·Var[m], N·Var[e],
N·Cov[m,e]): those are N (<xy> - <x><y>), a difference of nearly equal
means times N, so a last-digit change of the means moves them by about
N |<xy>| 1e-16.  For them it also prints the largest difference over N
times the larger of |<m²>| and |<e²>| on the row (``var_vs_means``), the
size of that change measured in the means that cancel.  Reads numpy
only; runs anywhere.
"""
import json
import sys

import numpy as np

MEANS = ("<m>", "<e>", "<m2>", "<e2>")
VARS = ("N*Var[m]", "N*Var[e]", "N*Cov[m,e]")
# --protocol samples rows: N, sample, t and one history's values
SAMPLES = ("m", "e", "m_y")


def rows(path: str) -> list[str]:
    with open(path) as f:
        return [line for line in f.read().splitlines()
                if not line.startswith("#")]


def compare(a: str, b: str) -> dict:
    ra, rb = rows(a), rows(b)
    res = {"a": a, "b": b, "rows": len(ra), "identical": ra == rb}
    if ra == rb:
        return res
    if len(ra) != len(rb):
        res["rows_b"] = len(rb)
        return res
    ta = np.array([[float(v) for v in line.split()] for line in ra])
    tb = np.array([[float(v) for v in line.split()] for line in rb])
    res["first_columns_equal"] = bool(np.array_equal(ta[:, :3], tb[:, :3]))
    rel = np.abs(ta - tb) / np.maximum(np.abs(ta), 1e-300)
    names = SAMPLES if ta.shape[1] <= 6 else MEANS + VARS
    res["rel"] = {names[j - 3]: float(rel[:, j].max())
                  for j in range(3, min(ta.shape[1], 3 + len(names)))}
    if names is SAMPLES:
        # m_y of an ordered state is a cancelled sum: its absolute change
        res["values_rel"] = max(res["rel"].values())
        res["values_abs"] = float(np.abs(ta[:, 3:] - tb[:, 3:]).max())
        return res
    res["means_rel"] = max(res["rel"][k] for k in MEANS)
    scale = ta[:, 0] * np.maximum(np.abs(ta[:, 5]), np.abs(ta[:, 6]))
    res["var_vs_means"] = float((np.abs(ta[:, 7:10] - tb[:, 7:10])
                                 / scale[:, None]).max())
    return res


def main(argv: list[str]) -> int:
    if len(argv) < 2 or len(argv) % 2:
        print(__doc__, file=sys.stderr)
        return 2
    for a, b in zip(argv[::2], argv[1::2]):
        print(json.dumps(compare(a, b)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
