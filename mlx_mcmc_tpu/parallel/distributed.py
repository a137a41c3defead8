"""Multi-host runtime initialization.

Thin wrapper over ``jax.distributed.initialize`` — the communication
backend the reference lacks entirely (SURVEY.md §2.3). Nothing detects a
cluster on its own here: pass ``coordinator_address`` (e.g.
``localhost:<port>``), ``num_processes`` and ``process_id`` explicitly,
on GPU hosts as in CPU multi-process tests.
"""

from __future__ import annotations

from typing import Optional

import jax


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize the JAX multi-host runtime (idempotent)."""
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:  # already initialized
        if "already" not in str(e).lower():
            raise
