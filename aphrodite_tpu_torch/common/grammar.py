"""Grammar-constrained decoding: lark-LALR incremental parsing + a
character-trie token validator + a logits processor.

Reference: `aphrodite/common/grammar.py:41-470` (FastInteractiveParser,
IncrementalParserState, TokenVocab, NextTokenValidator,
GrammarLogitsProcessor). Same capability, different machinery:

- Parser states are lark's IMMUTABLE interactive parsers (value stacks
  never matter — tokens are fed with empty values), so advancing a
  state is cheap and states intern by their LALR state stack; the
  reference deep-copies mutable parser states instead.
- Token validation walks a CHARACTER TRIE of the vocabulary: shared
  token prefixes are parsed once and invalid subtrees are pruned —
  the reference's per-token validation re-parses every token string.
- The processor masks numpy logits rows (our sampler applies host
  logits processors on numpy), no torch/ray.

A terminal may match a candidate completely (advance the LALR state),
partially (stay, remember the partial text), or not at all (prune).
Ignored terminals (whitespace) pass through without LALR stepping.
"""
from __future__ import annotations

import functools
from typing import Dict, Iterable, List, Optional, Set, Tuple

import numpy as np

try:
    import regex as _regex
except ImportError:                                    # pragma: no cover
    import re as _regex

from aphrodite_tpu_torch.common.logger import init_logger

logger = init_logger(__name__)

END = "$END"


def _matcher_for(pattern):
    """Build seq -> (processed, remainder, extendable) for one lark
    terminal pattern: (None, None, False) = no match; processed/remainder
    describe the longest complete match (remainder may be "");
    `extendable` = seq could still be a strict prefix of a LONGER match
    of this terminal (maximal munch must not commit yet)."""
    from lark.lexer import PatternRE, PatternStr

    if isinstance(pattern, PatternStr):
        literal = pattern.value

        @functools.lru_cache(maxsize=200_000)
        def match_str(seq: str):
            if seq.startswith(literal):
                return literal, seq[len(literal):], False
            if literal.startswith(seq):
                return None, None, True
            return None, None, False

        return match_str

    if isinstance(pattern, PatternRE):
        compiled = _regex.compile(pattern.value)

        @functools.lru_cache(maxsize=200_000)
        def match_re(seq: str):
            processed = remainder = None
            m = compiled.match(seq)
            if m is not None and m.start() == 0 and m.end() > 0:
                processed, remainder = seq[:m.end()], seq[m.end():]
            extendable = False
            try:
                # A partial fullmatch that consumes the WHOLE seq means
                # a longer match may still complete.
                pm = compiled.fullmatch(seq, partial=True)
                extendable = pm is not None and \
                    (m is None or m.end() == len(seq))
            except TypeError:                          # stdlib re
                pass
            return processed, remainder, extendable

        return match_re

    raise TypeError(f"Unsupported lark pattern {type(pattern)}")


class GrammarMatcher:
    """Incremental membership oracle for a lark grammar.

    A state is `(parser_key, partial)`: an interned immutable LALR
    parser plus the text of the current incomplete terminal. `advance`
    consumes more text and returns the next state or None.
    """

    def __init__(self, grammar: str, start: str = "start") -> None:
        from lark import Lark

        self.lark = Lark(grammar, parser="lalr", start=start,
                         regex=True)
        self._validators = {
            t.name: _matcher_for(t.pattern) for t in self.lark.terminals
        }
        self._ignored = set(self.lark.lexer_conf.ignore)
        base = self.lark.parse_interactive().as_immutable()
        self._parsers: Dict[tuple, object] = {}
        self.root = (self._intern(base), "")
        self._advance_memo: Dict[tuple, object] = {}
        self._accepts_memo: Dict[tuple, Set[str]] = {}

    # -- parser interning --

    def _intern(self, parser):
        # Key by the state-stack tuple itself (not its hash): dict
        # handles collisions, a raw hash key would conflate states.
        key = tuple(parser.parser_state.state_stack)
        self._parsers.setdefault(key, parser)
        return key

    def _accepts(self, parser_key: int) -> Set[str]:
        got = self._accepts_memo.get(parser_key)
        if got is None:
            got = set(self._parsers[parser_key].accepts()) | self._ignored
            self._accepts_memo[parser_key] = got
        return got

    # -- state transitions --

    def advance(self, state, text: str):
        """Consume `text` from `state`; None if no continuation exists."""
        parser_key, partial = state
        memo_key = (parser_key, partial, text)
        if memo_key in self._advance_memo:
            return self._advance_memo[memo_key]
        result = self._advance(parser_key, partial + text)
        if len(self._advance_memo) > 500_000:   # bound long-lived servers
            self._advance_memo.clear()
        self._advance_memo[memo_key] = result
        return result

    def _advance(self, parser_key: int, candidate: str):
        if candidate == "":
            return (parser_key, "")
        best = None
        for terminal in sorted(self._accepts(parser_key)):
            if terminal == END:
                continue
            processed, remainder, extendable = \
                self._validators[terminal](candidate)
            if extendable:
                # Maximal munch: some terminal may still grow — don't
                # commit; the complete-match option is recoverable later
                # because the full candidate text is retained.
                return (parser_key, candidate)
            if processed is not None and (
                    best is None or len(processed) > len(best[1])):
                # Longest complete match wins (standard lexer semantics
                # — sort order must not decide between overlapping
                # terminals).
                best = (terminal, processed, remainder)
        if best is None:
            return None
        terminal, processed, remainder = best
        next_key = self._feed(parser_key, terminal, processed)
        if remainder == "":
            return (next_key, "")
        return self._advance(next_key, remainder)

    def _feed(self, parser_key: int, terminal: str,
              text: str) -> int:
        if terminal in self._ignored:
            return parser_key
        from lark.lexer import Token
        parser = self._parsers[parser_key]
        return self._intern(parser.feed_token(Token(terminal, text)))

    def can_end(self, state) -> bool:
        """True if the input consumed so far is a complete sentence.

        `_advance` defers committing while any accepted terminal could
        still grow (maximal munch), so the pending partial may span
        SEVERAL complete terminals — e.g. with terminals AB="ab!",
        A="a", B="b" and input "ab", the state is deferred on AB but
        "ab" = A B may already be a full parse. A single
        longest-complete-match commit misses that (round-2 advisor
        finding), so this searches every complete-match split of the
        partial for one that reaches $END."""
        parser_key, partial = state
        # Every complete match consumes >= 1 char (match_re requires
        # m.end() > 0; literals are non-empty), so recursion depth is
        # bounded by the INITIAL partial length. The bound must not
        # shrink with the remainder: a split into N single-char
        # terminals legitimately recurses N deep.
        return self._can_end(parser_key, partial, len(partial) + 4, {})

    def _can_end(self, parser_key: int, partial: str,
                 depth_left: int, memo: dict) -> bool:
        # Memo scoped to one can_end call: overlapping short terminals
        # (A='a', AA='aa') reach the same (state, suffix) through
        # exponentially many split orders; each is decided once. A
        # memoized value must be depth-independent, so a False that was
        # (transitively) produced by the depth cutoff is NOT cached —
        # _can_end_memo reports the taint. In practice the cutoff
        # can never fire: every complete match consumes >= 1 char, so
        # partial shrinks at least as fast as depth_left and the
        # partial == "" base case wins the race (can_end starts depth
        # at len(partial) + 4); the taint tracking keeps the memo
        # correct even if that invariant ever changes.
        return self._can_end_memo(parser_key, partial, depth_left, memo)[0]

    def _can_end_memo(self, parser_key: int, partial: str,
                      depth_left: int, memo: dict):
        """Returns (result, hit_depth_cutoff); caches untainted results."""
        key = (parser_key, partial)
        hit = memo.get(key)
        if hit is not None:
            return hit, False
        accepts = self._accepts(parser_key)
        if partial == "":
            result, cut = END in accepts, False
        elif depth_left <= 0:                  # defensive cycle bound
            result, cut = False, True
        else:
            result, cut = False, False
            for terminal in sorted(accepts):
                if terminal == END:
                    continue
                processed, remainder, _ = \
                    self._validators[terminal](partial)
                if processed is None:
                    continue
                next_key = self._feed(parser_key, terminal, processed)
                sub, sub_cut = self._can_end_memo(
                    next_key, remainder, depth_left - 1, memo)
                cut = cut or sub_cut
                if sub:
                    result, cut = True, False
                    break
        if result or not cut:
            memo[key] = result
        return result, cut


class TokenTrie:
    """Character trie over the normalized vocabulary: token ids sit on
    the node that spells their decoded text."""

    __slots__ = ("children", "token_ids")

    def __init__(self):
        self.children: Dict[str, TokenTrie] = {}
        self.token_ids: List[int] = []

    def insert(self, text: str, token_id: int) -> None:
        node = self
        for ch in text:
            nxt = node.children.get(ch)
            if nxt is None:
                nxt = node.children[ch] = TokenTrie()
            node = nxt
        node.token_ids.append(token_id)


class NextTokenValidator:
    """Valid-next-token-id oracle for (tokenizer, grammar)
    (reference `grammar.py:391-428`)."""

    # Tries are grammar-independent; share per (tokenizer, charset).
    # Values hold the tokenizer too so its id() can't be recycled while
    # the cache entry lives.
    _trie_cache: Dict[Tuple[int, Optional[frozenset]],
                      Tuple[object, TokenTrie]] = {}

    def __init__(self, tokenizer, grammar: str,
                 grammar_start: str = "start",
                 legal_chars: Optional[Set[str]] = None) -> None:
        self.tokenizer = tokenizer
        self.matcher = GrammarMatcher(grammar, grammar_start)
        self.eos_token_id = tokenizer.eos_token_id
        chars_key = frozenset(legal_chars) if legal_chars else None
        cache_key = (id(tokenizer), chars_key)
        entry = self._trie_cache.get(cache_key)
        if entry is None or entry[0] is not tokenizer:
            entry = (tokenizer, self._build_trie(tokenizer, legal_chars))
            self._trie_cache[cache_key] = entry
        self.trie = entry[1]
        # Decoded-prefix -> parser state for incremental stepping.
        self._text_states: Dict[str, object] = {"": self.matcher.root}

    @staticmethod
    def _build_trie(tokenizer,
                    legal_chars: Optional[Set[str]]) -> TokenTrie:
        trie = TokenTrie()
        bos = tokenizer.bos_token_id
        special = set(getattr(tokenizer, "all_special_ids", []) or [])
        for token_id in sorted(tokenizer.vocab.values()):
            if token_id == tokenizer.eos_token_id or token_id in special:
                continue
            if bos is not None:
                text = tokenizer.decode([bos, token_id])
                text = text[len(tokenizer.bos_token):]
            else:
                text = tokenizer.decode([token_id])
            if not text:
                continue
            if legal_chars is not None and \
                    not all(c in legal_chars for c in text):
                continue
            trie.insert(text, token_id)
        return trie

    def state_for_text(self, text: str):
        """Parser state after consuming `text` (None = text has left the
        grammar; sampling should not have allowed it)."""
        got = self._text_states.get(text)
        if got is not None:
            return got
        if len(self._text_states) > 100_000:    # bound long-lived servers
            self._text_states = {"": self.matcher.root}
        # Find the longest cached prefix and advance the delta.
        for cut in range(len(text) - 1, -1, -1):
            prev = self._text_states.get(text[:cut])
            if prev is not None:
                nxt = self.matcher.advance(prev, text[cut:])
                if nxt is not None:
                    self._text_states[text] = nxt
                return nxt
        return None

    def valid_token_ids(self, text: str) -> Tuple[List[int], bool]:
        """(valid generated-token ids, eos_allowed) after `text`."""
        state = self.state_for_text(text)
        if state is None:
            return [], True        # out of grammar: only stopping left
        valid: List[int] = []
        stack = [(self.trie, state)]
        while stack:
            node, st = stack.pop()
            if node.token_ids:
                valid.extend(node.token_ids)
            for ch, child in node.children.items():
                nxt = self.matcher.advance(st, ch)
                if nxt is not None:
                    stack.append((child, nxt))
        return valid, self.matcher.can_end(state)


# Validators are expensive to build (full-vocab trie + LALR compile) and
# fully shareable: key by (tokenizer identity, grammar). Keeps the async
# server handler from re-doing ~vocab_size decode calls per request.
_VALIDATOR_CACHE: Dict[Tuple[int, str, str], NextTokenValidator] = {}


def get_validator(tokenizer, grammar: str,
                  grammar_start: str = "start") -> NextTokenValidator:
    key = (id(tokenizer), grammar, grammar_start)
    got = _VALIDATOR_CACHE.get(key)
    if got is None:
        got = NextTokenValidator(tokenizer, grammar, grammar_start)
        if len(_VALIDATOR_CACHE) > 64:
            _VALIDATOR_CACHE.clear()
        _VALIDATOR_CACHE[key] = got
    return got


class GrammarLogitsProcessor:
    """Host logits processor: -inf everything the grammar forbids
    (reference `grammar.py:430-445`). Called per sampler row with the
    request's output token ids and the numpy logits row."""

    def __init__(self, tokenizer, grammar: str,
                 grammar_start: str = "start") -> None:
        self.validator = get_validator(tokenizer, grammar, grammar_start)
        self.tokenizer = tokenizer
        # Incremental-decode states keyed by the FULL token-id prefix:
        # one processor instance serves every sibling sequence of an
        # n>1 / best_of request (the sampler shares the params object),
        # so per-prefix states are required for correctness, and they
        # make each step O(1) decodes instead of O(n). LRU-bounded:
        # old (short-prefix) entries evict first, live tips stay, so
        # memory is O(window * n) instead of O(n^2).
        from collections import OrderedDict
        self._states: "OrderedDict[tuple, tuple]" = OrderedDict()

    def _decode(self, token_ids: List[int]) -> str:
        from aphrodite_tpu_torch.transformers_utils.tokenizer import (
            detokenize_incrementally)
        if not token_ids:
            return ""
        if not hasattr(self.tokenizer, "convert_ids_to_tokens"):
            return self.tokenizer.decode(token_ids)    # simple tokenizers
        key = tuple(token_ids)
        got = self._states.get(key)
        if got is not None:
            self._states.move_to_end(key)
            return got[3]
        while len(self._states) > 512:
            self._states.popitem(last=False)      # evict oldest prefix
        # Extend the parent prefix's state, or rebuild from scratch.
        start = len(key) - 1 if key[:-1] in self._states else 0
        state = self._states.get(key[:-1], (None, 0, 0, ""))
        prev_tokens, prefix_off, read_off, text = state
        for i in range(start, len(token_ids)):
            new_toks, delta, prefix_off, read_off = \
                detokenize_incrementally(
                    self.tokenizer, token_ids[:i + 1], prev_tokens,
                    prefix_off, read_off)
            # First call returns ALL tokens, later calls the appended
            # one — accumulate like the engine does.
            prev_tokens = new_toks if prev_tokens is None \
                else prev_tokens + new_toks
            text += delta
        self._states[key] = (prev_tokens, prefix_off, read_off, text)
        return text

    def __call__(self, token_ids: List[int],
                 logits: np.ndarray) -> np.ndarray:
        text = self._decode(list(token_ids))
        valid, eos_ok = self.validator.valid_token_ids(text)
        mask = np.zeros(logits.shape[-1], dtype=bool)
        if valid:
            mask[np.asarray(valid, dtype=np.int64)] = True
        eos = self.validator.eos_token_id
        if eos_ok and eos is not None and eos < logits.shape[-1]:
            mask[eos] = True
        out = np.where(mask, logits, np.float32("-inf"))
        return out.astype(logits.dtype, copy=False)
