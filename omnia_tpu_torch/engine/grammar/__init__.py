"""Grammar-constrained decoding: compiled FSM token masking (the port's
own copy of ``omnia_tpu/engine/grammar/``, numpy only).

Turns JSON-Schema ``response_format`` specs, tool-call argument schemas,
and regexes into token-level transition tables the sampler masks with.
The compiled tables are the JAX package's, entry for entry, for the same
spec and tokenizer. The engine also takes a grammar compiled by the JAX
package: it reads only ``view``, ``validate``, ``key`` and ``eos_id``
(engine/placement.py).
"""

from omnia_tpu_torch.engine.grammar.cache import (
    clear_cache,
    compile_json_schema,
    compile_regex,
    compile_turn_grammar,
    grammar_cache_key,
    stats,
)
from omnia_tpu_torch.engine.grammar.fsm import (
    GrammarError,
    GrammarTooLarge,
    GrammarUnsupported,
    SamplerView,
    TokenGrammar,
    force_complete,
    walk_text,
)

__all__ = [
    "GrammarError",
    "GrammarTooLarge",
    "GrammarUnsupported",
    "SamplerView",
    "TokenGrammar",
    "clear_cache",
    "compile_json_schema",
    "compile_regex",
    "compile_turn_grammar",
    "force_complete",
    "grammar_cache_key",
    "stats",
    "walk_text",
]
