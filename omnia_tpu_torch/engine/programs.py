"""The serving engine's device programs (port of
``omnia_tpu/engine/programs.py``).

- ``prefill_insert``: a fresh bucketed prefill whose KV chunk is written
  WHOLE into the slot's rows 0..bucket-1 (pad rows sit past every real
  query position, so the causal mask hides them until decode overwrites
  them), then the first token sampled from the last real position. An
  int8 cache quantizes the chunk as it is written; a paged cache writes
  it through the slot's table row, which placement has made cover the
  bucket. On the card with the decode ring on, one rank and a contiguous
  cache, the engine replays it as one captured CUDA graph per bucket,
  whose slot and last row are device indices (``prefill_graphs.py``).
- ``decode_fns[k]``: ``k`` decode steps enqueued back to back. JAX's
  ``lax.scan`` becomes a Python loop over device tensors: no host sync
  inside a chunk, and stop-token / budget finishes are masked on the
  device, so a slot that finishes mid-chunk stops advancing.
  Every decode step of every program below is the one ``_step``.
  With ``decode_ring > 0`` the family is the decode ring's edition
  instead: the step also carries the deadline-step budget and the
  per-slot grammar EOS, and a step that starts with every slot of the
  whole batch done runs nothing (under dp the flag is OR-ed over the
  shards, as JAX's ``active`` spans the whole batch). Here that edition
  is eager and branches on the host (the CPU's route); on the card the
  engine replays it as one captured CUDA graph per chunk size, whose
  branch is a conditional node (``graphs.py``). ``decode_plain`` is one
  step of the plain edition whatever the ring: the decode half of a
  mixed step, alone, on a dp shard that does not hold the placing slot.
- ``mixed[b]`` / ``mixed_sample[b]`` (``prefill_chunk_tokens > 0``): a
  prompt piece of bucket ``b`` through the extend seam, then one decode
  step for every active slot, enqueued together; ``mixed_sample`` also
  samples the placed request's first token on the final piece.
- ``verify`` / ``verify_decode`` (``spec_decode > 0``): the verify
  window, a [B, W+1] forward whose (grammar-masked) greedy argmax is the
  acceptance oracle of prompt-lookup proposals; ``verify_decode`` adds
  one exact decode step for the slots that do not verify.
  ``mixed_spec[b]`` / ``mixed_spec_sample[b]`` carry the window in the
  mixed step. A window and a piece of more than one token run the plain
  attention path; every T == 1 forward on the card runs the cache's
  decode-attention kernel.
- ``extend`` / ``extend_nosample``: one piece of an incremental prefill
  against the slot's resident rows, with or without the first-token
  sample. JAX copies the slot out, runs the forward and writes it back
  (its arrays are immutable); here the forward runs on a one-slot view
  that writes in place: ``c[:, slot:slot+1]`` of a contiguous or int8
  cache, ``PagedKV(pool, table[slot:slot+1])`` of a paged one. A T == 1
  piece on the card therefore runs the engine's own decode-attention
  kernel with B = 1.
- ``prefill_ring`` / ``insert`` (``sp > 1``): a long fresh prompt's
  prefill as ring attention, each sp rank computing its block of the
  bucket's rows through every layer; the KV rows are then gathered over
  sp and the last real row's logits broadcast from the sp rank that
  holds it, so every sp rank leaves with the whole chunk. ``insert``
  writes the chunk into the slot's rows (every sp rank's cache: they are
  replicas) and samples the first token.
- ``offload`` / ``restore``: a session's leading rows out to a device
  copy ``[L, rows, Hkv, D]`` (the caller moves it to the host) and back
  into a slot's rows 0..rows-1, verbatim in the cache's representation.
- ``prefix_store`` / ``prefix_seed`` / ``prefix_offload`` (contiguous
  caches with ``prefix_cache_slots > 0``): a slot's leading rows into a
  shared-prefix pool entry, an entry into a fresh slot, an entry out to
  a device copy for the host tier. Entries keep the cache's
  representation, so int8 rows and scales move verbatim.
- ``page_copy`` / ``gather_pages`` / ``scatter_pages`` (paged caches):
  the copy-on-write page copy and the prefix host tier's page-run
  transfers. A paged prefix entry is a refcounted run of the one pool's
  pages, so publish and seed need no copy at all.

Grammar (``EngineConfig.grammar``): every first-token sampler takes one
extra operand, the start state's ``[V]`` mask bias, and the decode
chunk takes the per-slot FSM state, tables and active flags: each step
gathers each slot's ``[V]`` row ``gtable[b, gstate[b]]``, masks the
tokens whose entry is negative, and advances the state on the device.
Without it the programs take none of these operands.

Data parallelism (``dp``): each rank's programs run at its shard's
local batch and local slot rows, and the engine moves what crosses
shards (``dataparallel.py``). Two things inside a program span the
whole batch, as under GSPMD: an MoE layer of a forward over the batch's
slots (the decode step, the verify window) dispatches over the whole
batch (``ops/moe.py``), and the decode ring's all-done early-out reads
every shard's flags. A prefill or an extend piece runs one slot on its
owner shard: its rows are the whole batch already.

Every program runs with grad mode off, as JAX programs never
differentiate: a trainer's params serve as they are.

Tensor parallelism (``tp``): the forwards run this rank's heads, FFN,
experts and vocab slice; every sampler and the verify oracle read the
logits gathered over the ranks, so each rank samples the same tokens
from the same ``key_data`` and the ranks' host books stay equal. Only
the rows a sampler reads are gathered (one per slot, not a prefill's
``[1, bucket, V]``).

PyTorch launches are asynchronous, so every program returns as soon as
its work is enqueued; the caller reads tokens when it needs them. KV
caches are updated in place (JAX donates and returns them), every copy
on the one stream the engine uses, so each lands before the work
enqueued after it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from omnia_tpu_torch.engine.types import EngineConfig
from omnia_tpu_torch.models import ModelConfig, llama
from omnia_tpu_torch.models.kv_quant import cache_put, cache_put_slot, cache_take, kv_map
from omnia_tpu_torch.models import paged_kv as pkv
from omnia_tpu_torch.models.paged_kv import PagedKV, gather_rows, put_chunk
from omnia_tpu_torch.ops.sampling import _NEG_INF, sample_tokens_per_slot
from omnia_tpu_torch.parallel.collectives import all_reduce_max
from omnia_tpu_torch.utils.timeline import stamp


def _grammar_rows(gtable, gstate):
    """Each slot's current [V] transition row ``gtable[b, gstate[b]]``:
    the one gather idiom of the decode step's sampler mask and the
    verify window's oracle mask, so the two can never diverge."""
    rows = torch.arange(gtable.shape[0], device=gtable.device)
    return gtable[rows, gstate.long()]                          # [B, V]


def make_step(cfg: ModelConfig, max_seq: int, tp=None, dp=None) -> Callable:
    """The decode step ``_step`` over ``tp`` and ``dp`` (each a Comm or
    None): ``build_programs``' own, and the one the engine captures into
    the decode ring's graphs over communicators of their own
    (``engine._ring``)."""

    def _step(params, ck, cv, state, stop_ids, temp, top_p, top_k, g, geos=None):
        """One decode step over the fixed batch: the one source of the
        step's ops, shared by the chunk, the ring chunk (eager or
        captured), the mixed step and the verify step's scan lane, which
        is what keeps their tokens equal. ``state`` = (tokens, positions,
        active, budget, key_data, gstate), gstate None without the
        grammar; ``g`` = () or (gtable, gactive). Returns (the next
        state, the sampled tokens [B]).

        The ring edition (``decode_ring > 0``) carries the deadline-step
        budget as a seventh element of ``state``: decremented on active
        at the step's start, like the emission budget, and its
        exhaustion masks the slot from the next step on (the host
        finishes it DEADLINE at the same step). With the grammar it also
        takes ``geos``, the per-slot grammar EOS id (-1 = none), which
        stops a slot like a stop id (it covers an EOS cut off the
        8-wide stop-id row)."""
        tokens, positions, active, budget, key_data, gstate = state[:6]
        logits, _, _ = llama.forward(params, cfg, tokens[:, None], positions[:, None], ck, cv,
                                     positions, tp, dp)
        logits = llama.gather_logits(logits[:, 0], tp)
        if g:
            gtable, gactive = g
            row = _grammar_rows(gtable, gstate)
            bias = torch.where(gactive[:, None] & (row < 0), _NEG_INF, 0.0)
            tok, key_data = sample_tokens_per_slot(logits, key_data, temp, top_p, top_k,
                                                   mask_bias=bias)
            # The state advances on the sampled token, gated like the
            # position (active at the step's start); a masked token cannot
            # be sampled, so the max only covers inactive slots' samples.
            nxt = torch.gather(row, 1, tok[:, None].long())[:, 0]
            gstate = torch.where(gactive & active, nxt.clamp_min(0), gstate)
        else:
            tok, key_data = sample_tokens_per_slot(logits, key_data, temp, top_p, top_k)
        # The head's region (utils/timeline.py) ends with the sampler.
        stamp("end")
        # The row just written advances the position only for slots active
        # at the step's start; deactivation applies from the next step on,
        # as the host's finish bookkeeping does.
        positions = torch.where(active, torch.clamp(positions + 1, max=max_seq - 1), positions)
        budget = budget - active.to(torch.int32)
        ring = state[6:]
        if ring:
            ring = (ring[0] - active.to(torch.int32),)
        hit_stop = (tok[:, None] == stop_ids).any(dim=1)
        if geos is not None:
            # Token ids are >= 0, so a slot without a grammar (-1) never
            # matches.
            hit_stop = hit_stop | (tok == geos)
        active = active & ~hit_stop & (budget > 0)
        if ring:
            active = active & (ring[0] > 0)
        tokens = torch.where(active | hit_stop, tok, tokens)
        return (tokens, positions, active, budget, key_data, gstate) + ring, tok

    return _step


@dataclasses.dataclass(frozen=True)
class EnginePrograms:
    prefill_insert: Callable
    decode_fns: dict[int, Callable]
    # The ring prefill and its insert (sp > 1, else None).
    prefill_ring: Optional[Callable]
    insert: Optional[Callable]
    # One decode step of the plain edition (a mixed step's decode half).
    decode_plain: Callable
    # One decode step (``_step``): what the captured ring chunk replays.
    step: Callable
    extend: Callable
    extend_nosample: Callable
    offload: Callable
    restore: Callable
    # Shared-prefix pool transfers (contiguous caches with
    # prefix_cache_slots > 0, else None).
    prefix_store: Optional[Callable] = None
    prefix_seed: Optional[Callable] = None
    prefix_offload: Optional[Callable] = None
    # Paged caches (kv_pages > 0, else None).
    page_copy: Optional[Callable] = None
    gather_pages: Optional[Callable] = None
    scatter_pages: Optional[Callable] = None
    # Speculative decoding (spec_decode > 0, else None).
    verify: Optional[Callable] = None
    verify_decode: Optional[Callable] = None
    # Fused prefill-piece + decode steps, one per piece bucket
    # (prefill_chunk_tokens > 0, else empty; the spec editions also need
    # spec_decode > 0).
    mixed: dict[int, Callable] = dataclasses.field(default_factory=dict)
    mixed_sample: dict[int, Callable] = dataclasses.field(default_factory=dict)
    mixed_spec: dict[int, Callable] = dataclasses.field(default_factory=dict)
    mixed_spec_sample: dict[int, Callable] = dataclasses.field(default_factory=dict)


def build_programs(cfg: ModelConfig, ecfg: EngineConfig, tp=None, sp=None,
                   dp=None) -> EnginePrograms:
    """The engine's programs; with ``tp`` (the "tp" axis's Comm) every
    forward runs this rank's slice and every sampler reads the gathered
    logits; with ``sp`` (the "sp" axis's Comm) the sp ring attention's
    prefill runs this rank's block of rows; with ``dp`` (the "dp" axis's
    Comm) the forwards over the slots and the decode ring's early-out
    span every shard."""
    max_seq = ecfg.max_seq
    paged = ecfg.kv_pages > 0

    def _put(c, chunk, slot, start):
        """Write a slot-row chunk [L, 1, T, H, D] at rows [start, start+T)."""
        if paged:
            return put_chunk(c, chunk, slot, start)
        return cache_put(c, chunk, (0, slot, start))

    def _slot_view(c, slot):
        """One slot's [L, 1, S, H, D] view of an engine cache; forward's
        writes through it land in the cache."""
        if paged:
            return PagedKV(c.pool, c.table[slot:slot + 1])
        return kv_map(lambda a: a[:, slot:slot + 1], c)

    def _sample_one(logits, key_data, temp, top_p, top_k, g):
        """``g`` is () or (the start state's mask bias [V],)."""
        logits = llama.gather_logits(logits, tp)
        tok, new_kd = sample_tokens_per_slot(logits, key_data[None], temp, top_p, top_k,
                                             mask_bias=g[0][None] if g else None)
        return tok[0], new_kd[0]

    def prefill_insert(params, ck, cv, tokens, positions, slot, last_idx, key_data, temp,
                       top_p, top_k, *g):
        """tokens, positions [1, bucket]; key_data [2]; temp, top_p,
        top_k [1]; g the grammar bias, if any → (first token 0-d int32,
        new key_data [2]). ``slot`` and ``last_idx`` are ints, or on a
        contiguous cache device indices (int64 [1]), which the captured
        prefill reads at each replay (``prefill_graphs.py``): the same
        rows written, the same row's logits sampled."""
        logits, k_chunk, v_chunk = llama.forward_prefill(params, cfg, tokens, positions, tp)
        if torch.is_tensor(slot):
            cache_put_slot(ck, k_chunk, slot)
            cache_put_slot(cv, v_chunk, slot)
            last = logits.index_select(1, last_idx)[:, 0]
        else:
            _put(ck, k_chunk, slot, 0)
            _put(cv, v_chunk, slot, 0)
            last = logits[:, last_idx]
        return _sample_one(last, key_data, temp, top_p, top_k, g)

    def prefill_ring(params, tokens, positions, last_idx: int):
        """tokens, positions [1, bucket], the whole prompt on every sp rank
        → (the row ``last_idx``'s logits [1, V] (this rank's vocab slice
        under tp), k_chunk, v_chunk [L, 1, bucket, Hkv, D]) on every sp
        rank: the ring forward of this rank's rows, then the KV rows
        gathered over sp and the logits broadcast by the rank that holds
        row ``last_idx``."""
        logits, k_rows, v_rows = llama.forward_prefill_ring(params, cfg, tokens, positions,
                                                            tp, sp)
        block = logits.shape[1]
        holder = last_idx // block
        row = logits[:, last_idx - holder * block] if sp.index == holder else logits[:, 0]
        last = sp.broadcast(row, holder)
        return last, sp.all_gather(k_rows, dim=2), sp.all_gather(v_rows, dim=2)

    def insert(ck, cv, k_chunk, v_chunk, slot: int, last_logits, key_data, temp, top_p,
               top_k, *g):
        """The ring prefill's chunk [L, 1, bucket, Hkv, D] into the slot's
        rows 0..bucket-1, then the first token sampled from its last real
        row's logits [1, V] → (token 0-d int32, new key_data [2])."""
        _put(ck, k_chunk, slot, 0)
        _put(cv, v_chunk, slot, 0)
        return _sample_one(last_logits, key_data, temp, top_p, top_k, g)

    def extend_nosample(params, ck, cv, tokens, positions, slot: int, write_start):
        """tokens, positions [1, T]; write_start int32 [1] → logits
        [1, T, V]: the piece's rows written into the slot."""
        logits, _, _ = llama.forward(params, cfg, tokens, positions,
                                     _slot_view(ck, slot), _slot_view(cv, slot),
                                     write_start, tp)
        return logits

    def extend(params, ck, cv, tokens, positions, slot: int, write_start,
               last_idx: int, key_data, temp, top_p, top_k, *g):
        """The final piece: extend_nosample, then the first token sampled
        at ``last_idx`` → (token 0-d int32, new key_data [2])."""
        logits = extend_nosample(params, ck, cv, tokens, positions, slot, write_start)
        return _sample_one(logits[:, last_idx], key_data, temp, top_p, top_k, g)

    def offload(ck, cv, slot: int, rows: int):
        """A slot's rows [0, rows) → [L, rows, H, D] on the device: a
        view of a contiguous cache, a gather of the pages covering them
        from a paged one. The caller copies them to the host at once."""
        if paged:
            return gather_rows(ck, slot, rows), gather_rows(cv, slot, rows)
        L = ck.shape[0]
        return tuple(kv_map(lambda a: a[:, 0], cache_take(c, (0, slot, 0), (L, 1, rows)))
                     for c in (ck, cv))

    def restore(ck, cv, k_rows, v_rows, slot: int):
        """rows [L, R, H, D] (cache representation) → the slot's rows [0, R)."""
        _put(ck, kv_map(lambda a: a[:, None], k_rows), slot, 0)
        _put(cv, kv_map(lambda a: a[:, None], v_rows), slot, 0)

    _step = make_step(cfg, max_seq, tp, dp)

    def any_active(active) -> bool:
        """Whether any slot of the whole batch is active (the host's read
        of the decode ring's predicate): OR-ed over the dp shards."""
        flag = active.any().to(torch.int32).reshape(1)
        return bool(all_reduce_max(flag, dp).item())

    def _outputs(ck, cv, state, grammar_on: bool) -> tuple:
        """A step's state as the programs return it: (ck, cv, tokens,
        positions, active, budget, key_data) and gstate with the grammar."""
        out = (ck, cv) + tuple(state[:5])
        return out + (state[5],) if grammar_on else out

    def make_decode(chunk: int, ring: bool = False) -> Callable:
        def decode_chunk(params, ck, cv, tokens, positions, active, budget,
                         stop_ids, key_data, temp, top_p, top_k, *g):
            """``chunk`` decode steps → (ck, cv, tokens, positions, active,
            budget, key_data, toks [chunk, B]); with ``g = (gstate,
            gtable, gactive)`` the per-slot grammar masks every step and
            gstate rides the outputs before toks."""
            state = (tokens, positions, active, budget, key_data, g[0] if g else None)
            toks = []
            for _ in range(chunk):
                state, tok = _step(params, ck, cv, state, stop_ids, temp, top_p, top_k, g[1:])
                toks.append(tok)
            return _outputs(ck, cv, state, bool(g)) + (torch.stack(toks),)

        def decode_chunk_ring(params, ck, cv, tokens, positions, active, budget,
                              stop_ids, key_data, temp, top_p, top_k, *rest):
            """The ring edition: ``rest`` = [gstate, gtable, gactive, geos]
            with the grammar, then the deadline-step budget dl int32 [B].
            Returns decode_chunk's outputs with dl before toks (JAX's
            carry order). A step that starts with no slot of the whole
            batch active runs nothing: its output row is the frozen token
            vector and the state passes through, as JAX's ``lax.cond``
            dead branch does. This eager edition reads ``active`` on the
            host (OR-ed over dp) to branch; on the card the chunk is
            captured instead (graphs.py), where the branch is a
            conditional node on the device."""
            *g, dl = rest
            geos = g.pop() if g else None
            state = (tokens, positions, active, budget, key_data, g[0] if g else None, dl)
            toks = []
            for _ in range(chunk):
                if not any_active(state[2]):
                    toks.append(state[0])
                    continue
                state, tok = _step(params, ck, cv, state, stop_ids, temp, top_p, top_k,
                                   tuple(g[1:]), geos)
                toks.append(tok)
            return _outputs(ck, cv, state, bool(g)) + (state[6], torch.stack(toks))

        fn = decode_chunk_ring if ring else decode_chunk
        fn.__name__ = f"{fn.__name__}_{chunk}"
        return fn

    def _verify_window(params, ck, cv, vtoks, vpos, vwstart, g):
        """The speculative verify half: one forward over [B, W+1] tokens
        (each slot's last token and its proposals) written at per-slot
        rows ``vwstart``; the greedy argmax at every position is the
        acceptance oracle. Rejected proposals leave garbage rows at or
        past the slot's new frontier, which the next writes overwrite.

        With ``g = (gstate, gtable, gactive)`` the oracle is the masked
        argmax: each position's grammar row masks as the sampler does,
        and the state walks along the PROPOSED stream, so every oracle
        token within the accepted prefix is admissible. A masked proposal
        makes the states after it garbage, but it also disagrees with the
        oracle at its own position, so acceptance stops there."""
        logits, _, _ = llama.forward(params, cfg, vtoks, vpos, ck, cv, vwstart, tp, dp)
        logits = llama.gather_logits(logits, tp)
        if not g:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        state, gtable, gactive = g
        T = vtoks.shape[1]
        cols = []
        for t in range(T):
            row = _grammar_rows(gtable, state)
            bias = torch.where(gactive[:, None] & (row < 0), _NEG_INF, 0.0)
            cols.append(torch.argmax(logits[:, t] + bias, dim=-1).to(torch.int32))
            if t + 1 < T:
                nxt = torch.gather(row, 1, vtoks[:, t + 1, None].long())[:, 0]
                state = torch.where(gactive, nxt.clamp_min(0), state)
        return torch.stack(cols, dim=1)

    def _vmasked_decode_step(params, ck, cv, tokens, positions, active, budget,
                             stop_ids, key_data, temp, top_p, top_k, vmask, vshift: int, g):
        """One ``_step`` with the verify-lane slots masked out: they run
        inactive (frozen sampler state; the host sets their tokens and
        positions after acceptance) and their unavoidable garbage row is
        parked ``vshift`` rows past their frontier, one row beyond the
        window they just wrote, past any frontier acceptance can reach.
        The scan-lane slots take the exact chunk step."""
        state = (tokens, torch.where(vmask, positions + vshift, positions), active & ~vmask,
                 budget, key_data, g[0] if g else None)
        (o_tok, o_pos, o_act, o_bud, o_kd, o_gs), tok = _step(
            params, ck, cv, state, stop_ids, temp, top_p, top_k, g[1:])
        # Verify-lane slots ran inactive, so their FSM state passed
        # through the step unchanged.
        out = (torch.where(vmask, tokens, o_tok), torch.where(vmask, positions, o_pos),
               torch.where(vmask, active, o_act), torch.where(vmask, budget, o_bud),
               torch.where(vmask[:, None], key_data, o_kd), o_gs)
        return _outputs(ck, cv, out, bool(g)), tok[None]

    ring_on = ecfg.sp > 1
    progs = dict(
        prefill_insert=prefill_insert,
        prefill_ring=prefill_ring if ring_on else None,
        insert=insert if ring_on else None,
        # decode_ring > 0 swaps the whole decode family for the ring
        # edition; ring off builds the programs it always had.
        decode_fns={k: make_decode(k, ring=ecfg.decode_ring > 0) for k in ecfg.chunk_variants()},
        decode_plain=make_decode(1),
        step=_step,
        extend=extend,
        extend_nosample=extend_nosample,
        offload=offload,
        restore=restore,
    )
    if ecfg.spec_decode > 0:
        def verify(params, ck, cv, tokens, positions, write_start, *g):
            """The bare verify window, for batches without a scan-lane slot
            → greedy [B, W+1]."""
            return _verify_window(params, ck, cv, tokens, positions, write_start, g)

        def verify_decode(params, ck, cv, tokens, positions, active, budget, stop_ids,
                          key_data, temp, top_p, top_k, vtoks, vpos, vwstart, vmask, *g):
            """The verify window, then one exact decode step for the
            scan-lane slots (sampled, or first token not through) →
            decode_chunk's outputs at K = 1, then greedy [B, W+1]."""
            greedy = _verify_window(params, ck, cv, vtoks, vpos, vwstart, g)
            out, toks = _vmasked_decode_step(params, ck, cv, tokens, positions, active,
                                             budget, stop_ids, key_data, temp, top_p, top_k,
                                             vmask, vtoks.shape[1], g)
            return out + (toks, greedy)

        progs.update(verify=verify, verify_decode=verify_decode)
    if ecfg.prefill_chunk_tokens > 0:
        def make_mixed(bucket: int, sample: bool, spec: bool) -> Callable:
            def mixed_step(params, ck, cv, tokens, positions, active, budget, stop_ids,
                           key_data, temp, top_p, top_k, ptoks, ppos, pslot: int, pwrite,
                           *rest):
                """A prompt piece through the one-slot extend seam, then
                one decode step for every active slot, in one enqueue.
                ``rest`` = [vtoks, vpos, vwstart, vmask] (spec), then
                [plast, pkd, ptemp, ptop_p, ptop_k, *pg] (sample), then
                [gstate, gtable, gactive] (grammar). The placing slot is
                inactive in the decode half; the engine parks its frozen
                row at the piece's end, where the next piece (or the
                first real decode write) overwrites the garbage. Returns
                decode_chunk's outputs at K = 1, then (first token, new
                key_data) when sampling, then greedy [B, W+1] with spec."""
                rest = list(rest)
                g = tuple(rest[-3:]) if grammar_on else ()
                if grammar_on:
                    del rest[-3:]
                if spec:
                    vtoks, vpos, vwstart, vmask = rest[:4]
                    del rest[:4]
                plogits = extend_nosample(params, ck, cv, ptoks, ppos, pslot, pwrite)
                extra = ()
                if sample:
                    plast, pkd, ptemp, ptop_p, ptop_k = rest[:5]
                    extra = _sample_one(plogits[:, plast], pkd, ptemp, ptop_p, ptop_k,
                                        tuple(rest[5:]))
                if spec:
                    # The verify window after the piece (the placing
                    # slot's garbage window parks at the piece's end),
                    # then the decode step with the verify lane masked.
                    greedy = _verify_window(params, ck, cv, vtoks, vpos, vwstart, g)
                    out, toks = _vmasked_decode_step(
                        params, ck, cv, tokens, positions, active, budget, stop_ids,
                        key_data, temp, top_p, top_k, vmask, vtoks.shape[1], g)
                    return out + (toks,) + extra + (greedy,)
                state, tok = _step(params, ck, cv,
                                   (tokens, positions, active, budget, key_data,
                                    g[0] if g else None),
                                   stop_ids, temp, top_p, top_k, g[1:])
                return _outputs(ck, cv, state, grammar_on) + (tok[None],) + extra

            mixed_step.__name__ = (f"mixed_{'spec_' if spec else ''}"
                                   f"{'sample_' if sample else ''}{bucket}")
            return mixed_step

        grammar_on = bool(ecfg.grammar)
        for key, sample, spec in (("mixed", False, False), ("mixed_sample", True, False),
                                  ("mixed_spec", False, True),
                                  ("mixed_spec_sample", True, True)):
            if spec and ecfg.spec_decode <= 0:
                continue
            progs[key] = {b: make_mixed(b, sample, spec) for b in ecfg.mixed_prefill_buckets()}
    if ecfg.prefix_cache_slots > 0 and not paged:
        def _slot_rows(c, idx: int, rows: int):
            """Rows [0, rows) of batch row ``idx`` as [L, 1, rows, H, D]."""
            return cache_take(c, (0, idx, 0), (c.shape[0], 1, rows))

        def prefix_store(pool_k, pool_v, ck, cv, slot: int, pool_idx: int, rows: int):
            """A slot's rows [0, rows) → pool entry ``pool_idx``."""
            cache_put(pool_k, _slot_rows(ck, slot, rows), (0, pool_idx, 0))
            cache_put(pool_v, _slot_rows(cv, slot, rows), (0, pool_idx, 0))

        def prefix_seed(ck, cv, pool_k, pool_v, pool_idx: int, slot: int, rows: int):
            """Pool entry ``pool_idx``'s rows [0, rows) → a slot's rows."""
            cache_put(ck, _slot_rows(pool_k, pool_idx, rows), (0, slot, 0))
            cache_put(cv, _slot_rows(pool_v, pool_idx, rows), (0, slot, 0))

        def prefix_offload(pool_k, pool_v, pool_idx: int, rows: int):
            """Pool entry rows → [L, rows, H, D] views; the caller copies
            them to the host at once."""
            return tuple(kv_map(lambda a: a[:, 0], _slot_rows(p, pool_idx, rows))
                         for p in (pool_k, pool_v))

        progs.update(prefix_store=prefix_store, prefix_seed=prefix_seed,
                     prefix_offload=prefix_offload)
    if paged:
        def page_copy(ck, cv, src: int, dst: int):
            pkv.copy_page(ck.pool, src, dst)
            pkv.copy_page(cv.pool, src, dst)

        def gather_pages(ck, cv, idx):
            return pkv.gather_pages(ck.pool, idx), pkv.gather_pages(cv.pool, idx)

        def scatter_pages(ck, cv, idx, k_pages, v_pages):
            pkv.scatter_pages(ck.pool, idx, k_pages)
            pkv.scatter_pages(cv.pool, idx, v_pages)

        progs.update(page_copy=page_copy, gather_pages=gather_pages,
                     scatter_pages=scatter_pages)
    # JAX programs never differentiate: every program runs with grad mode
    # off (warmup's and the ring capture's calls too), so params that
    # require grad (a trainer's) serve directly and record no graph.
    off = torch.no_grad()
    return EnginePrograms(**{
        name: {b: off(f) for b, f in fn.items()} if isinstance(fn, dict)
        else fn if fn is None else off(fn)
        for name, fn in progs.items()})
