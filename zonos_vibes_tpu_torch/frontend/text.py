"""(The PyTorch port's own copy of the JAX package's module of the same name.)

Host-side text normalization (English numbers + Japanese) and the phoneme
symbol table/tokenizer.

Behavioral spec: reference zonos/conditioning.py:70-186. The reference leans
on the ``inflect`` package for number expansion; this module implements the
same expansions natively (cardinals with scale-group commas, hyphenated tens,
ordinals, year grouping with "oh") so the frontend has zero exotic
dependencies. Japanese normalization (NFKC + digits->kanji + SudachiPy
reading forms, conditioning.py:171-175) runs when sudachipy/kanjize are
importable and degrades to NFKC-only otherwise.
"""

from __future__ import annotations

import re
import unicodedata

# ---------------------------------------------------------------------------
# English number-to-words (inflect-equivalent subset)
# ---------------------------------------------------------------------------

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALES = [
    (10**33, "decillion"), (10**30, "nonillion"), (10**27, "octillion"),
    (10**24, "septillion"), (10**21, "sextillion"), (10**18, "quintillion"),
    (10**15, "quadrillion"), (10**12, "trillion"), (10**9, "billion"),
    (10**6, "million"), (10**3, "thousand"),
]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _under_100(n: int) -> str:
    if n < 20:
        return _ONES[n]
    tens, units = divmod(n, 10)
    return _TENS[tens] + ("-" + _ONES[units] if units else "")


def _under_1000(n: int, andword: str) -> str:
    hundreds, rest = divmod(n, 100)
    parts = []
    if hundreds:
        parts.append(_ONES[hundreds] + " hundred")
    if rest:
        if hundreds and andword:
            parts.append(andword)
        parts.append(_under_100(rest))
    return " ".join(parts)


def number_to_words(n: int, andword: str = "and", zero: str = "zero") -> str:
    """Cardinal words with inflect-style scale-group commas:
    ``1234567 -> "one million, two hundred thirty-four thousand, five hundred
    sixty-seven"`` (with ``andword=""``)."""
    if n < 0:
        return "minus " + number_to_words(-n, andword, zero)
    if n == 0:
        return zero
    groups = []
    for scale, name in _SCALES:
        if n >= scale:
            q, n = divmod(n, scale)
            groups.append(_under_1000(q, andword) + " " + name)
    if n:
        groups.append(_under_1000(n, andword))
    return ", ".join(groups)


def number_to_words_grouped(n: int, group: int = 2, zero: str = "oh") -> str:
    """inflect ``group=2`` year-style expansion: split the digit string into
    ``group``-digit chunks from the left, expand each, join with spaces
    (``1999 -> "nineteen ninety-nine"``, ``2024 -> "twenty twenty-four"``,
    ``1904 -> "nineteen oh four"``)."""
    s = str(n)
    head = len(s) % group
    chunks = ([s[:head]] if head else []) + [
        s[i : i + group] for i in range(head, len(s), group)
    ]
    words = []
    for c in chunks:
        if set(c) == {"0"}:
            words.append(" ".join(zero for _ in c))
        elif c[0] == "0":
            words.append(zero + " " + _under_100(int(c)))
        else:
            words.append(_under_100(int(c)) if len(c) <= 2 else _under_1000(int(c), ""))
    return " ".join(words)


def ordinal_words(n: int) -> str:
    """``21 -> "twenty-first"``."""
    words = number_to_words(n, andword="")
    # Replace only the final word with its ordinal form.
    m = re.search(r"(\w+)$", words)
    last = m.group(1)
    if last in _ORDINAL_IRREGULAR:
        repl = _ORDINAL_IRREGULAR[last]
    elif last.endswith("y"):
        repl = last[:-1] + "ieth"
    else:
        repl = last + "th"
    return words[: m.start(1)] + repl


# ---------------------------------------------------------------------------
# Normalization pipeline (conditioning.py:70-136 semantics)
#
# Lineage: the six regexes and the _expand_dollars/_expand_number branch
# structure below are behavior-pinning constants matching the reference's
# normalize-numbers block near-verbatim — which the reference itself
# vendors from the MIT-licensed keithito/tacotron text cleaners (via the
# VITS line). Bit-identical normalization is a parity requirement (any
# drift changes the phoneme stream and everything downstream); the
# number-to-words engine above replaces the reference's `inflect`
# dependency and is original.
# ---------------------------------------------------------------------------

_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")


def _expand_dollars(m: re.Match) -> str:
    match = m.group(1)
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        return "%s %s, %s %s" % (
            dollars, "dollar" if dollars == 1 else "dollars",
            cents, "cent" if cents == 1 else "cents",
        )
    if dollars:
        return "%s %s" % (dollars, "dollar" if dollars == 1 else "dollars")
    if cents:
        return "%s %s" % (cents, "cent" if cents == 1 else "cents")
    return "zero dollars"


def _expand_number(m: re.Match) -> str:
    num = int(m.group(0))
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return "two thousand " + number_to_words(num % 100)
        if num % 100 == 0:
            return number_to_words(num // 100, andword="") + " hundred"
        return number_to_words_grouped(num, group=2, zero="oh")
    return number_to_words(num, andword="")


def normalize_numbers(text: str) -> str:
    text = _comma_number_re.sub(lambda m: m.group(1).replace(",", ""), text)
    text = _pounds_re.sub(r"\1 pounds", text)
    text = _dollars_re.sub(_expand_dollars, text)
    text = _decimal_number_re.sub(lambda m: m.group(1).replace(".", " point "), text)
    text = _ordinal_re.sub(lambda m: ordinal_words(int(m.group(0)[:-2])), text)
    text = _number_re.sub(_expand_number, text)
    return text


_JP_TOKENIZER = None
_JP_AVAILABLE: bool | None = None


_KANJI_DIGITS = "〇一二三四五六七八九"
_KANJI_SMALL = ((1000, "千"), (100, "百"), (10, "十"))
_KANJI_MYRIADS = (
    (10 ** 20, "垓"), (10 ** 16, "京"), (10 ** 12, "兆"),
    (10 ** 8, "億"), (10 ** 4, "万"),
)


def number_to_kanji(n: int) -> str:
    """Native digits->kanji (kanjize.number2kanji semantics, reference
    conditioning.py:171-175): positional myriad groups, with the customary
    omitted 一 before 十/百/千 inside a group."""
    if n == 0:
        return _KANJI_DIGITS[0]
    if n < 0:
        return "マイナス" + number_to_kanji(-n)
    if n >= 10 ** 24:
        # Beyond the supported myriad units: digit-wise kanji (never crash
        # on absurd numeric runs in user text).
        return "".join(_KANJI_DIGITS[int(c)] for c in str(n))

    def group(g: int) -> str:  # 1..9999
        out = []
        for unit, name in _KANJI_SMALL:
            d, g = divmod(g, unit)
            if d:
                out.append(("" if d == 1 else _KANJI_DIGITS[d]) + name)
        if g:
            out.append(_KANJI_DIGITS[g])
        return "".join(out)

    parts = []
    for unit, name in _KANJI_MYRIADS:
        d, n = divmod(n, unit)
        if d:
            parts.append(group(d) + name)
    if n:
        parts.append(group(n))
    return "".join(parts)


def normalize_jp_text(text: str) -> str:
    """NFKC + digits->kanji + SudachiPy reading forms when the optional JP
    stack is importable; NFKC + native digits->kanji fallback otherwise
    (environment-gated — do NOT pip install)."""
    global _JP_TOKENIZER, _JP_AVAILABLE
    text = unicodedata.normalize("NFKC", text)
    if _JP_AVAILABLE is None:
        try:
            from kanjize import number2kanji  # noqa: F401
            from sudachipy import Dictionary, SplitMode  # noqa: F401

            _JP_TOKENIZER = Dictionary(dict="full").create()
            _JP_AVAILABLE = True
        except Exception:
            _JP_AVAILABLE = False
    if not _JP_AVAILABLE:
        # Reading-form tokenization needs the Sudachi dictionary, but the
        # numeric expansion does not — keep that part of the contract.
        return re.sub(r"\d+", lambda m: number_to_kanji(int(m[0])), text)
    from kanjize import number2kanji
    from sudachipy import SplitMode

    text = re.sub(r"\d+", lambda m: number2kanji(int(m[0])), text)
    return " ".join(
        t.reading_form() for t in _JP_TOKENIZER.tokenize(text, SplitMode.A)
    )


def clean(texts: list[str], languages: list[str]) -> list[str]:
    return [
        normalize_jp_text(t) if "ja" in lang else normalize_numbers(t)
        for t, lang in zip(texts, languages)
    ]


# ---------------------------------------------------------------------------
# Phoneme symbol table + tokenizer (conditioning.py:138-168)
# ---------------------------------------------------------------------------

PAD_ID, UNK_ID, BOS_ID, EOS_ID = 0, 1, 2, 3
SPECIAL_TOKEN_IDS = (PAD_ID, UNK_ID, BOS_ID, EOS_ID)

PUNCTUATION = ';:,.!?¡¿—…"«»“”() *~-/\\&'
_LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
_LETTERS_IPA = (
    "ɑɐɒæɓʙβɔɕçɗɖðʤəɘɚɛɜɝɞɟʄɡɠɢʛɦɧħɥʜɨɪʝɭɬɫɮʟɱɯɰŋɳɲɴøɵɸθœɶʘɹɺɾɻʀʁɽʂʃʈʧʉʊʋⱱʌɣɤʍχʎʏʑʐʒʔʡʕʢǀǁǂǃˈˌːˑʼʴʰʱʲʷˠˤ˞↓↑→↗↘'̩'ᵻ"
)
SYMBOLS = [*PUNCTUATION, *_LETTERS, *_LETTERS_IPA]
_SYMBOL_TO_ID = {s: i for i, s in enumerate(SYMBOLS, start=len(SPECIAL_TOKEN_IDS))}

VOCAB_SIZE = len(SPECIAL_TOKEN_IDS) + len(SYMBOLS)


def get_symbol_ids(text: str) -> list[int]:
    return [_SYMBOL_TO_ID.get(ch, UNK_ID) for ch in text]


def tokenize_phonemes(phonemes: list[str]) -> tuple[list[list[int]], list[int]]:
    """Per-item ``[BOS, *ids, EOS]`` then LEFT-pad with PAD to the batch max
    (conditioning.py:163-168). Returns (padded ids, true lengths)."""
    ids = [[BOS_ID, *get_symbol_ids(p), EOS_ID] for p in phonemes]
    lengths = [len(x) for x in ids]
    longest = max(lengths)
    padded = [[PAD_ID] * (longest - len(x)) + x for x in ids]
    return padded, lengths
