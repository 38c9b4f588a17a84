#!/usr/bin/env python3
"""Run a checkout's ``chip_smoke.py`` with each of its phases timed.

``chip_smoke.py`` prints a ``phase_s`` line for each phase that returns;
a checkout whose smoke predates those lines can be timed with this
script instead. From the root of that checkout, on the card:
``python3 /path/to/smoke_phase_times.py``. Every function the smoke marks
with ``@phase`` is wrapped, and each call prints one JSON line,
``{"phase_timing": name, "thread", "start_s", "end_s", "seconds"}``, on
the smoke's clock; the smoke's own output and exit code are unchanged.
"""

import faulthandler
import importlib.util
import json
import os
import sys
import threading
import time


def timed(mod, name, fn):
    def inner(*args, **kwargs):
        t0 = time.perf_counter() - mod._T0
        try:
            return fn(*args, **kwargs)
        finally:
            t1 = time.perf_counter() - mod._T0
            print(json.dumps({"phase_timing": name, "thread": threading.current_thread().name,
                              "start_s": round(t0, 2), "end_s": round(t1, 2),
                              "seconds": round(t1 - t0, 2)}), flush=True)

    return inner


def main() -> int:
    faulthandler.enable()
    os.environ["PYTHONFAULTHANDLER"] = "1"
    sys.path.insert(0, os.getcwd())
    sys.argv = ["chip_smoke.py"]
    spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    # @phase's wrapper is a closure named "wrapper": those are the phases
    for name, obj in list(vars(mod).items()):
        if callable(obj) and getattr(getattr(obj, "__code__", None), "co_name", None) == "wrapper":
            setattr(mod, name, timed(mod, name, obj))
    return mod.main()


if __name__ == "__main__":
    sys.exit(main())
