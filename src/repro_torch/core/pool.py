"""Resource kinds of the pool model (paper §3, §6).

Only the kind constants that stages carry (``Function.resource``) live here
so far; the ``Pool``/``NicSpec`` ledger arrives with the control plane.
"""
from __future__ import annotations

# Resource type for CPU-like general cores (paper: ARM A72 "resource units").
CPU = "cpu"

# Accelerator kinds that appear in the paper's cluster.
REGEX = "regex"
CRYPTO = "crypto"          # paper: AES accelerator (Pensando)
COMPRESSION = "compression"
