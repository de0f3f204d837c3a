"""Mixtral is the Mistral decoder with sparse experts: the ``mistral``
family reads ``num_local_experts`` and serves both."""

from portbench.families.mistral import *  # noqa: F401,F403
