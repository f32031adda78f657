"""A fake `dbt` executable: a stdlib script for the dbt step's `exec`
runtime, after the one of ``tests/e2e/test_container_e2e.py``.  It
records the arguments it was given and the `profiles.yml` of its
`--profiles-dir` as JSON into the file that `$FAKE_DBT_RECORD` names
(appending one line a run), and prints dbt's closing line.

    FAKE_DBT_RECORD=runs.jsonl python3 fake_dbt.py run \\
        --profiles-dir D --project-dir P --profile transferia
"""

from __future__ import annotations

import json
import os
import sys


def main(argv: list) -> int:
    out = {"argv": argv}
    if "--profiles-dir" in argv:
        path = os.path.join(argv[argv.index("--profiles-dir") + 1],
                            "profiles.yml")
        with open(path) as fh:
            out["profiles"] = fh.read()
    record = os.environ.get("FAKE_DBT_RECORD")
    if record:
        with open(record, "a") as fh:
            fh.write(json.dumps(out) + "\n")
    print("Completed successfully")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
