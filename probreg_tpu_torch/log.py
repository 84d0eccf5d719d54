"""Module logger (parity with reference probreg/log.py:1-6)."""

import logging

log = logging.getLogger("probreg_tpu_torch")
log.setLevel(logging.INFO)
if not log.handlers:
    ch = logging.StreamHandler()
    log.addHandler(ch)
else:  # re-import: keep the module-level handler name (reference log.py:4-6)
    ch = log.handlers[0]
