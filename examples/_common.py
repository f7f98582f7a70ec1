"""Shared example bootstrap.

``example_setup()`` reads ``SQP_EXAMPLE_QUICK``, the test suite's smoke
mode.  Every example must shrink its budget (batch, steps, iterations)
when it returns True so the suite's smoke runs stay cheap.
"""

import os


def example_setup() -> bool:
    """Return whether SQP_EXAMPLE_QUICK smoke mode is on."""
    return os.environ.get("SQP_EXAMPLE_QUICK") == "1"
