"""(The PyTorch port's own copy of the JAX package's module of the same name.)

Host-side phonemization — native espeak-ng binding with graceful fallback.

The reference phonemizes through the ``phonemizer`` package wrapping the
espeak-ng C library (conditioning.py:189-216): per-language backend with
``preserve_punctuation=True, with_stress=True`` and the Zonos punctuation
set, ``strip=True``. Phonemization is inherently host-side (it is a C text
library, not a TPU op).

This module provides three tiers, best available wins:

1. the ``phonemizer`` package, if importable (identical behavior to the
   reference — preferred for golden parity);
2. a direct ``ctypes`` binding to ``libespeak-ng`` (TextToPhonemes with IPA
   output), when the shared library is present;
3. a deterministic rule-based grapheme fallback so the full pipeline stays
   runnable (and testable) on machines without espeak — clearly marked,
   NOT parity-bearing.

All three return IPA-ish strings over the symbol table in
``frontend/text.py``.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import re

from .text import PUNCTUATION, clean

_BACKEND: str | None = None


@functools.cache
def backend_name() -> str:
    """Which tier is active: ``phonemizer`` | ``espeak-ng`` | ``fallback``."""
    try:
        import phonemizer  # noqa: F401

        return "phonemizer"
    except ImportError:
        pass
    if _find_espeak_lib() is not None:
        return "espeak-ng"
    return "fallback"


@functools.cache
def _find_espeak_lib():
    for name in ("espeak-ng", "espeak"):
        path = ctypes.util.find_library(name)
        if path:
            try:
                return ctypes.CDLL(path)
            except OSError:
                continue
    return None


@functools.cache
def _phonemizer_backend(language: str):
    import logging

    from phonemizer.backend import EspeakBackend

    logger = logging.getLogger("phonemizer")
    backend = EspeakBackend(
        language,
        preserve_punctuation=True,
        with_stress=True,
        punctuation_marks=PUNCTUATION,
        logger=logger,
    )
    logger.setLevel(logging.ERROR)
    return backend


# --- ctypes espeak-ng tier --------------------------------------------------

_ESPEAK_INITIALIZED = False
_espeakCHARS_AUTO = 0
_espeakPHONEMES_IPA = 0x02


def _espeak_init(lib) -> None:
    global _ESPEAK_INITIALIZED
    if _ESPEAK_INITIALIZED:
        return
    # AUDIO_OUTPUT_SYNCH_PLAYBACK=0 .. RETRIEVAL=1 .. SYNCHRONOUS=2
    lib.espeak_Initialize(2, 0, None, 0)
    _ESPEAK_INITIALIZED = True


def _espeak_phonemize(lib, text: str, language: str) -> str:
    _espeak_init(lib)
    lib.espeak_SetVoiceByName(language.encode())
    out_parts = []
    ptr = ctypes.c_char_p(text.encode("utf-8"))
    ref = ctypes.byref(ptr)
    lib.espeak_TextToPhonemes.restype = ctypes.c_char_p
    # phoneme_mode: bits 0-7 separator, bit 1 IPA; textmode: UTF-8 = 1
    mode = (ord(" ") << 8) | _espeakPHONEMES_IPA
    while ptr.value:
        res = lib.espeak_TextToPhonemes(ref, 1, mode)
        if res is None:
            break
        out_parts.append(res.decode("utf-8", errors="ignore"))
    return " ".join(p.strip() for p in out_parts if p.strip())


# Split class: the conditioning punctuation set MINUS whitespace — the
# space in PUNCTUATION is a symbol-table entry, not a phrase boundary
# (splitting there would phonemize word-by-word and lose connected speech).
_PUNCT_SPLIT_RE = re.compile(
    f"([{re.escape(PUNCTUATION.replace(' ', ''))}]+\\s*)"
)


def _espeak_phonemize_preserving(lib, text: str, language: str) -> str:
    """Punctuation-preserving wrapper over the raw ctypes tier.

    ``espeak_TextToPhonemes`` consumes punctuation silently, but the
    reference phonemizes with ``preserve_punctuation=True,
    punctuation_marks=_punctuation`` (conditioning.py:189-216) and the
    marks are real symbols of the conditioning vocabulary
    (conditioning.py:145-160) — dropping them starves the model of
    prosody cues. Mirror the phonemizer package's approach: split at
    punctuation runs, phonemize each text chunk, re-insert the marks in
    place (attached to the preceding chunk, one space between segments —
    the package's restore semantics under ``strip=True``)."""
    parts = _PUNCT_SPLIT_RE.split(text)
    out = ""
    for i, part in enumerate(parts):
        if not part:
            continue
        if i % 2:  # punctuation run (possibly with trailing whitespace)
            out = out.rstrip() + part.strip() + " "
        else:
            ph = _espeak_phonemize(lib, part, language)
            if ph:
                out += ph + " "
    return out.strip()


# --- rule-based fallback tier ----------------------------------------------

_FALLBACK_MAP = {
    # coarse EN grapheme->IPA rules; deterministic, covers the symbol table
    "ch": "ʧ", "sh": "ʃ", "th": "θ", "ph": "f", "wh": "w", "qu": "kw",
    "ng": "ŋ", "oo": "uː", "ee": "iː", "ea": "iː", "ou": "aʊ", "ow": "aʊ",
    "ai": "eɪ", "ay": "eɪ", "oi": "ɔɪ", "oy": "ɔɪ",
    "a": "æ", "b": "b", "c": "k", "d": "d", "e": "ɛ", "f": "f", "g": "ɡ",
    "h": "h", "i": "ɪ", "j": "ʤ", "k": "k", "l": "l", "m": "m", "n": "n",
    "o": "ɒ", "p": "p", "q": "k", "r": "ɹ", "s": "s", "t": "t", "u": "ʌ",
    "v": "v", "w": "w", "x": "ks", "y": "j", "z": "z",
}
_FALLBACK_RE = re.compile(
    "|".join(sorted(_FALLBACK_MAP, key=len, reverse=True)) + "|."
    , re.DOTALL,
)


def _fallback_phonemize(text: str) -> str:
    """Deterministic grapheme-level pseudo-phonemization. Keeps punctuation
    and whitespace; maps letters through coarse EN rules. NOT espeak parity —
    used only when no espeak tier is available."""

    def sub(m: re.Match) -> str:
        tok = m.group(0)
        low = tok.lower()
        return _FALLBACK_MAP.get(low, tok if not tok.isalpha() else low)

    return _FALLBACK_RE.sub(sub, text.strip())


def phonemize(texts: list[str], languages: list[str]) -> list[str]:
    """Normalize then phonemize each (text, language) pair
    (reference conditioning.py:207-216)."""
    texts = clean(texts, languages)
    tier = backend_name()
    out = []
    for text, language in zip(texts, languages):
        if tier == "phonemizer":
            out.append(_phonemizer_backend(language).phonemize([text], strip=True)[0])
        elif tier == "espeak-ng":
            out.append(_espeak_phonemize_preserving(
                _find_espeak_lib(), text, language))
        else:
            out.append(_fallback_phonemize(text))
    return out
