"""Copied from ``tts_tpu/text/numbers_multilingual.py`` (the port imports nothing of ``tts_tpu``);
unchanged apart from this line and import paths.

Multilingual number verbalization for the XTTS text frontend.

The reference delegates to the ``num2words`` package
(``TTS/tts/layers/xtts/tokenizer.py:518`` _expand_number); that package is
not available here, so cardinals/decimals/currency are verbalized natively
for the Romance/Germanic XTTS languages.  English lives in
``tts_tpu.text.english``; languages without a verbalizer fall through
unchanged (digits are still BPE-tokenizable).
"""

from __future__ import annotations

import re

# ---------------------------------------------------------------------------
# per-language cardinal verbalizers (0 .. 999,999,999)
# ---------------------------------------------------------------------------

_ES_UNITS = ["cero", "uno", "dos", "tres", "cuatro", "cinco", "seis", "siete",
             "ocho", "nueve", "diez", "once", "doce", "trece", "catorce",
             "quince", "dieciséis", "diecisiete", "dieciocho", "diecinueve",
             "veinte", "veintiuno", "veintidós", "veintitrés", "veinticuatro",
             "veinticinco", "veintiséis", "veintisiete", "veintiocho",
             "veintinueve"]
_ES_TENS = {30: "treinta", 40: "cuarenta", 50: "cincuenta", 60: "sesenta",
            70: "setenta", 80: "ochenta", 90: "noventa"}
_ES_HUNDREDS = {100: "cien", 200: "doscientos", 300: "trescientos",
                400: "cuatrocientos", 500: "quinientos", 600: "seiscientos",
                700: "setecientos", 800: "ochocientos", 900: "novecientos"}


def _es_under_1000(n: int) -> str:
    if n < 30:
        return _ES_UNITS[n]
    if n < 100:
        t, u = divmod(n, 10)
        return _ES_TENS[t * 10] + (f" y {_ES_UNITS[u]}" if u else "")
    h, rest = divmod(n, 100)
    head = "ciento" if h == 1 and rest else _ES_HUNDREDS[h * 100]
    return head + (f" {_es_under_1000(rest)}" if rest else "")


def _es_cardinal(n: int) -> str:
    if n < 1000:
        return _es_under_1000(n)
    if n < 1_000_000:
        k, rest = divmod(n, 1000)
        head = "mil" if k == 1 else f"{_es_under_1000(k)} mil"
        return head + (f" {_es_under_1000(rest)}" if rest else "")
    m, rest = divmod(n, 1_000_000)
    head = "un millón" if m == 1 else f"{_es_under_1000(m)} millones"
    return head + (f" {_es_cardinal(rest)}" if rest else "")


_FR_UNITS = ["zéro", "un", "deux", "trois", "quatre", "cinq", "six", "sept",
             "huit", "neuf", "dix", "onze", "douze", "treize", "quatorze",
             "quinze", "seize", "dix-sept", "dix-huit", "dix-neuf"]
_FR_TENS = {20: "vingt", 30: "trente", 40: "quarante", 50: "cinquante",
            60: "soixante"}


def _fr_under_100(n: int) -> str:
    if n < 20:
        return _FR_UNITS[n]
    if n < 70:
        t, u = divmod(n, 10)
        base = _FR_TENS[t * 10]
        if u == 0:
            return base
        if u == 1:
            return f"{base} et un"
        return f"{base}-{_FR_UNITS[u]}"
    if n < 80:  # soixante-dix .. soixante-dix-neuf
        if n == 71:
            return "soixante et onze"
        return f"soixante-{_FR_UNITS[n - 60]}"
    if n < 100:  # quatre-vingts .. quatre-vingt-dix-neuf
        if n == 80:
            return "quatre-vingts"
        return f"quatre-vingt-{_FR_UNITS[n - 80] if n - 80 < 20 else ''}"
    raise ValueError(n)


def _fr_under_1000(n: int) -> str:
    if n < 100:
        return _fr_under_100(n)
    h, rest = divmod(n, 100)
    if h == 1:
        head = "cent"
    else:
        head = f"{_FR_UNITS[h]} cent" + ("s" if rest == 0 else "")
    return head + (f" {_fr_under_100(rest)}" if rest else "")


def _fr_cardinal(n: int) -> str:
    if n < 1000:
        return _fr_under_1000(n)
    if n < 1_000_000:
        k, rest = divmod(n, 1000)
        head = "mille" if k == 1 else f"{_fr_under_1000(k)} mille"
        return head + (f" {_fr_under_1000(rest)}" if rest else "")
    m, rest = divmod(n, 1_000_000)
    head = "un million" if m == 1 else f"{_fr_under_1000(m)} millions"
    return head + (f" {_fr_cardinal(rest)}" if rest else "")


_DE_UNITS = ["null", "eins", "zwei", "drei", "vier", "fünf", "sechs",
             "sieben", "acht", "neun", "zehn", "elf", "zwölf", "dreizehn",
             "vierzehn", "fünfzehn", "sechzehn", "siebzehn", "achtzehn",
             "neunzehn"]
_DE_TENS = {20: "zwanzig", 30: "dreißig", 40: "vierzig", 50: "fünfzig",
            60: "sechzig", 70: "siebzig", 80: "achtzig", 90: "neunzig"}


def _de_under_100(n: int, final: bool = True) -> str:
    if n < 20:
        if n == 1 and not final:
            return "ein"
        return _DE_UNITS[n]
    t, u = divmod(n, 10)
    if u == 0:
        return _DE_TENS[t * 10]
    unit = "ein" if u == 1 else _DE_UNITS[u]
    return f"{unit}und{_DE_TENS[t * 10]}"


def _de_under_1000(n: int, final: bool = True) -> str:
    if n < 100:
        return _de_under_100(n, final)
    h, rest = divmod(n, 100)
    head = ("ein" if h == 1 else _DE_UNITS[h]) + "hundert"
    return head + (_de_under_100(rest, final) if rest else "")


def _de_cardinal(n: int) -> str:
    if n < 1000:
        return _de_under_1000(n)
    if n < 1_000_000:
        k, rest = divmod(n, 1000)
        head = ("ein" if k == 1 else _de_under_1000(k, final=False)) + "tausend"
        return head + (_de_under_1000(rest) if rest else "")
    m, rest = divmod(n, 1_000_000)
    head = "eine million" if m == 1 else f"{_de_under_1000(m, final=False)} millionen"
    return head + (f" {_de_cardinal(rest)}" if rest else "")


_IT_UNITS = ["zero", "uno", "due", "tre", "quattro", "cinque", "sei", "sette",
             "otto", "nove", "dieci", "undici", "dodici", "tredici",
             "quattordici", "quindici", "sedici", "diciassette", "diciotto",
             "diciannove"]
_IT_TENS = {20: "venti", 30: "trenta", 40: "quaranta", 50: "cinquanta",
            60: "sessanta", 70: "settanta", 80: "ottanta", 90: "novanta"}


def _it_under_100(n: int) -> str:
    if n < 20:
        return _IT_UNITS[n]
    t, u = divmod(n, 10)
    base = _IT_TENS[t * 10]
    if u == 0:
        return base
    if u in (1, 8):  # vowel elision: ventuno, ventotto
        base = base[:-1]
    return base + _IT_UNITS[u]  # accent fix ("ventitré") in _it_fix_tre


def _it_fix_tre(word: str) -> str:
    return re.sub(r"tre$", "tré", word) if word.endswith("tre") and len(word) > 3 else word


def _it_under_1000(n: int) -> str:
    if n < 100:
        return _it_fix_tre(_it_under_100(n))
    h, rest = divmod(n, 100)
    head = "cento" if h == 1 else f"{_IT_UNITS[h]}cento"
    # accent applies to the whole compound ("centotré"), so fix after joining
    return _it_fix_tre(head + (_it_under_100(rest) if rest else ""))


def _it_cardinal(n: int) -> str:
    if n < 1000:
        return _it_under_1000(n)
    if n < 1_000_000:
        k, rest = divmod(n, 1000)
        head = "mille" if k == 1 else f"{_it_under_1000(k)}mila"
        return head + (_it_under_1000(rest) if rest else "")
    m, rest = divmod(n, 1_000_000)
    head = "un milione" if m == 1 else f"{_it_under_1000(m)} milioni"
    return head + (f" {_it_cardinal(rest)}" if rest else "")


_PT_UNITS = ["zero", "um", "dois", "três", "quatro", "cinco", "seis", "sete",
             "oito", "nove", "dez", "onze", "doze", "treze", "catorze",
             "quinze", "dezesseis", "dezessete", "dezoito", "dezenove"]
_PT_TENS = {20: "vinte", 30: "trinta", 40: "quarenta", 50: "cinquenta",
            60: "sessenta", 70: "setenta", 80: "oitenta", 90: "noventa"}
_PT_HUNDREDS = {100: "cem", 200: "duzentos", 300: "trezentos",
                400: "quatrocentos", 500: "quinhentos", 600: "seiscentos",
                700: "setecentos", 800: "oitocentos", 900: "novecentos"}


def _pt_under_1000(n: int) -> str:
    if n < 20:
        return _PT_UNITS[n]
    if n < 100:
        t, u = divmod(n, 10)
        return _PT_TENS[t * 10] + (f" e {_PT_UNITS[u]}" if u else "")
    h, rest = divmod(n, 100)
    head = "cento" if h == 1 and rest else _PT_HUNDREDS[h * 100]
    return head + (f" e {_pt_under_1000(rest)}" if rest else "")


def _pt_cardinal(n: int) -> str:
    if n < 1000:
        return _pt_under_1000(n)
    if n < 1_000_000:
        k, rest = divmod(n, 1000)
        head = "mil" if k == 1 else f"{_pt_under_1000(k)} mil"
        joiner = " e " if rest and (rest < 100 or rest % 100 == 0) else " "
        return head + (joiner + _pt_under_1000(rest) if rest else "")
    m, rest = divmod(n, 1_000_000)
    head = "um milhão" if m == 1 else f"{_pt_under_1000(m)} milhões"
    return head + (f" {_pt_cardinal(rest)}" if rest else "")


_CARDINALS = {
    "es": _es_cardinal,
    "fr": _fr_cardinal,
    "de": _de_cardinal,
    "it": _it_cardinal,
    "pt": _pt_cardinal,
}

_DECIMAL_WORD = {"es": "coma", "fr": "virgule", "de": "komma", "it": "virgola",
                 "pt": "vírgula", "en": "point"}

_CURRENCY_WORDS = {
    # symbol -> (lang -> (singular, plural))
    "$": {"en": ("dollar", "dollars"), "es": ("dólar", "dólares"),
          "fr": ("dollar", "dollars"), "de": ("dollar", "dollar"),
          "it": ("dollaro", "dollari"), "pt": ("dólar", "dólares")},
    "€": {"en": ("euro", "euros"), "es": ("euro", "euros"),
          "fr": ("euro", "euros"), "de": ("euro", "euro"),
          "it": ("euro", "euro"), "pt": ("euro", "euros")},
    "£": {"en": ("pound", "pounds"), "es": ("libra", "libras"),
          "fr": ("livre", "livres"), "de": ("pfund", "pfund"),
          "it": ("sterlina", "sterline"), "pt": ("libra", "libras")},
}


def number_to_words(n: int, lang: str) -> str:
    """Cardinal for ``lang``; returns the digit string untouched when the
    language has no verbalizer (still tokenizable)."""
    fn = _CARDINALS.get(lang)
    if fn is None or n >= 1_000_000_000:
        return str(n)
    return fn(n)


def expand_numbers_multilingual(text: str, lang: str) -> str:
    """Currency, decimals, then plain cardinals (mirrors the behavior of
    reference ``expand_numbers_multilingual``, tokenizer.py:522)."""
    if lang not in _CARDINALS:
        return text

    def _currency_words(sym: str, n: int):
        words = _CURRENCY_WORDS.get(sym, {}).get(lang)
        if not words:
            return None
        if len(words) == 3:  # slavic one/few/many declension
            unit = _ru_plural(n, *words)
        else:
            unit = words[0] if n == 1 else words[1]
        return f"{number_to_words(n, lang)} {unit}"

    def _cur_pre(m):  # "$5"
        return _currency_words(m.group(1), int(m.group(2))) or m.group(0)

    def _cur_post(m):  # "5€"
        return _currency_words(m.group(2), int(m.group(1))) or m.group(0)

    text = re.sub(r"([$€£])(\d+)", _cur_pre, text)
    text = re.sub(r"(\d+)\s*([$€£])", _cur_post, text)

    def _decimal(m):
        whole, frac = m.group(1), m.group(2)
        digits = " ".join(number_to_words(int(d), lang) for d in frac)
        return f"{number_to_words(int(whole), lang)} {_DECIMAL_WORD[lang]} {digits}"

    text = re.sub(r"(\d+),(\d+)", _decimal, text)
    text = re.sub(r"\d+", lambda m: number_to_words(int(m.group(0)), lang), text)
    return text


_ABBREVIATIONS = {
    "es": {"sr": "señor", "sra": "señora", "dr": "doctor", "dra": "doctora",
           "srta": "señorita", "av": "avenida", "ud": "usted"},
    "fr": {"m": "monsieur", "mme": "madame", "mlle": "mademoiselle",
           "dr": "docteur", "st": "saint", "av": "avenue"},
    "de": {"dr": "doktor", "prof": "professor", "st": "sankt",
           "hr": "herr", "fr": "frau", "nr": "nummer"},
    "it": {"sig": "signore", "dott": "dottore", "prof": "professore",
           "av": "avvocato", "ing": "ingegnere"},
    "pt": {"sr": "senhor", "sra": "senhora", "dr": "doutor", "dra": "doutora",
           "av": "avenida", "prof": "professor"},
    "en": {"dr": "doctor", "mr": "mister", "mrs": "misess", "st": "saint",
           "co": "company", "jr": "junior"},
}


def expand_abbreviations_multilingual(text: str, lang: str) -> str:
    """(reference ``tokenizer.py:235``; tables rebuilt, same contract)"""
    table = _ABBREVIATIONS.get(lang)
    if not table:
        return text
    for abbr, full in table.items():
        text = re.sub(rf"\b{abbr}\.", full, text, flags=re.IGNORECASE)
    return text


# ---------------------------------------------------------------------------
# Chinese (reference delegates to zh_num2words TextNorm, tokenizer.py:524)
# ---------------------------------------------------------------------------

_ZH_DIGITS = "零一二三四五六七八九"
_ZH_UNITS = ["", "十", "百", "千"]


def _zh_under_10000(n: int) -> str:
    if n == 0:
        return "零"
    out, zero_pending = [], False
    for pos in range(3, -1, -1):
        d = (n // 10 ** pos) % 10
        if d == 0:
            if out:
                zero_pending = True
            continue
        if zero_pending:
            out.append("零")
            zero_pending = False
        # 两 before 百/千 (common reading); bare 二 elsewhere
        digit = "两" if (d == 2 and pos >= 2) else _ZH_DIGITS[d]
        out.append(digit + _ZH_UNITS[pos])
    word = "".join(out)
    return word[1:] if word.startswith("一十") else word  # 12 → 十二


def zh_number_to_words(n: int) -> str:
    """Cardinal in hanzi for 0 .. 10^12-1 (groups of 万/亿)."""
    if n < 10000:
        return _zh_under_10000(n)
    parts = []
    yi, rest = divmod(n, 10 ** 8)
    wan, low = divmod(rest, 10000)
    group = lambda g: "两" if g == 2 else _zh_under_10000(g)  # 两万 / 两亿
    if yi:
        # 亿-group recurses: 万亿 and beyond (e.g. 123万亿 → 一百二十三万...亿)
        parts.append((group(yi) if yi < 10000 else zh_number_to_words(yi)) + "亿")
    if wan:
        if yi and wan < 1000:
            parts.append("零")
        parts.append(group(wan) + "万")
    if low:
        if low < 1000:
            parts.append("零")
        parts.append(_zh_under_10000(low))
    return "".join(parts)


def expand_numbers_zh(text: str) -> str:
    """Digits → hanzi; decimals read digit-by-digit after 点."""

    def _dec(m):
        whole = zh_number_to_words(int(m.group(1)))
        frac = "".join(_ZH_DIGITS[int(d)] for d in m.group(2))
        return f"{whole}点{frac}"

    text = re.sub(r"(\d+)\.(\d+)", _dec, text)
    return re.sub(r"\d+", lambda m: zh_number_to_words(int(m.group(0))), text)


# ---------------------------------------------------------------------------
# Russian (nominative cardinals; thousands take the feminine forms)
# ---------------------------------------------------------------------------

_RU_UNITS = ["ноль", "один", "два", "три", "четыре", "пять", "шесть", "семь",
             "восемь", "девять", "десять", "одиннадцать", "двенадцать",
             "тринадцать", "четырнадцать", "пятнадцать", "шестнадцать",
             "семнадцать", "восемнадцать", "девятнадцать"]
_RU_TENS = {20: "двадцать", 30: "тридцать", 40: "сорок", 50: "пятьдесят",
            60: "шестьдесят", 70: "семьдесят", 80: "восемьдесят",
            90: "девяносто"}
_RU_HUNDREDS = {100: "сто", 200: "двести", 300: "триста", 400: "четыреста",
                500: "пятьсот", 600: "шестьсот", 700: "семьсот",
                800: "восемьсот", 900: "девятьсот"}


def _ru_under_1000(n: int, feminine: bool = False) -> str:
    parts = []
    h, rest = divmod(n, 100)
    if h:
        parts.append(_RU_HUNDREDS[h * 100])
    if rest >= 20:
        t, u = divmod(rest, 10)
        parts.append(_RU_TENS[t * 10])
        rest = u
    if rest:
        if feminine and rest == 1:
            parts.append("одна")
        elif feminine and rest == 2:
            parts.append("две")
        else:
            parts.append(_RU_UNITS[rest])
    return " ".join(parts) if parts else _RU_UNITS[0]


def _ru_plural(n: int, one: str, few: str, many: str) -> str:
    if n % 100 in (11, 12, 13, 14):
        return many
    if n % 10 == 1:
        return one
    if n % 10 in (2, 3, 4):
        return few
    return many


def _ru_cardinal(n: int) -> str:
    if n < 1000:
        return _ru_under_1000(n)
    if n < 1_000_000:
        k, rest = divmod(n, 1000)
        head = f"{_ru_under_1000(k, feminine=True)} " + _ru_plural(
            k, "тысяча", "тысячи", "тысяч")
        return head + (f" {_ru_under_1000(rest)}" if rest else "")
    m, rest = divmod(n, 1_000_000)
    head = f"{_ru_under_1000(m)} " + _ru_plural(m, "миллион", "миллиона", "миллионов")
    return head + (f" {_ru_cardinal(rest)}" if rest else "")


# ---------------------------------------------------------------------------
# Dutch (German-style agglutination with "en"/"ën" joints)
# ---------------------------------------------------------------------------

_NL_UNITS = ["nul", "een", "twee", "drie", "vier", "vijf", "zes", "zeven",
             "acht", "negen", "tien", "elf", "twaalf", "dertien", "veertien",
             "vijftien", "zestien", "zeventien", "achttien", "negentien"]
_NL_TENS = {20: "twintig", 30: "dertig", 40: "veertig", 50: "vijftig",
            60: "zestig", 70: "zeventig", 80: "tachtig", 90: "negentig"}


def _nl_under_100(n: int) -> str:
    if n < 20:
        return _NL_UNITS[n]
    t, u = divmod(n, 10)
    if u == 0:
        return _NL_TENS[t * 10]
    joint = "ën" if _NL_UNITS[u].endswith("e") else "en"  # tweeëntwintig
    return f"{_NL_UNITS[u]}{joint}{_NL_TENS[t * 10]}"


def _nl_under_1000(n: int) -> str:
    if n < 100:
        return _nl_under_100(n)
    h, rest = divmod(n, 100)
    head = "honderd" if h == 1 else f"{_NL_UNITS[h]}honderd"
    return head + (_nl_under_100(rest) if rest else "")


def _nl_cardinal(n: int) -> str:
    if n < 1000:
        return _nl_under_1000(n)
    if n < 1_000_000:
        k, rest = divmod(n, 1000)
        head = "duizend" if k == 1 else f"{_nl_under_1000(k)}duizend"
        return head + (f" {_nl_under_1000(rest)}" if rest else "")
    m, rest = divmod(n, 1_000_000)
    head = "een miljoen" if m == 1 else f"{_nl_under_1000(m)} miljoen"
    return head + (f" {_nl_cardinal(rest)}" if rest else "")


_CARDINALS["ru"] = _ru_cardinal
_CARDINALS["nl"] = _nl_cardinal
_DECIMAL_WORD["ru"] = "запятая"
_DECIMAL_WORD["nl"] = "komma"
_CURRENCY_WORDS["$"]["ru"] = ("доллар", "доллара", "долларов")
_CURRENCY_WORDS["$"]["nl"] = ("dollar", "dollar")
_CURRENCY_WORDS["€"]["ru"] = ("евро", "евро", "евро")
_CURRENCY_WORDS["€"]["nl"] = ("euro", "euro")
_CURRENCY_WORDS["£"]["ru"] = ("фунт", "фунта", "фунтов")
_CURRENCY_WORDS["£"]["nl"] = ("pond", "pond")


# ---------------------------------------------------------------------------
# Turkish, Polish, Hungarian (the remaining regular XTTS languages;
# Arabic/Czech/ja/ko stay digit-passthrough pending proper morphology)
# ---------------------------------------------------------------------------

_TR_UNITS = ["sıfır", "bir", "iki", "üç", "dört", "beş", "altı", "yedi",
             "sekiz", "dokuz"]
_TR_TENS = {10: "on", 20: "yirmi", 30: "otuz", 40: "kırk", 50: "elli",
            60: "altmış", 70: "yetmiş", 80: "seksen", 90: "doksan"}


def _tr_under_1000(n: int) -> str:
    if n == 0:
        return _TR_UNITS[0]
    parts = []
    h, rest = divmod(n, 100)
    if h:
        parts.append(("" if h == 1 else _TR_UNITS[h] + " ") + "yüz")
    t, u = divmod(rest, 10)
    if t:
        parts.append(_TR_TENS[t * 10])
    if u:
        parts.append(_TR_UNITS[u])
    return " ".join(parts)


def _tr_cardinal(n: int) -> str:
    if n < 1000:
        return _tr_under_1000(n)
    if n < 1_000_000:
        k, rest = divmod(n, 1000)
        head = ("" if k == 1 else _tr_under_1000(k) + " ") + "bin"
        return head + (f" {_tr_under_1000(rest)}" if rest else "")
    m, rest = divmod(n, 1_000_000)
    head = f"{_tr_under_1000(m)} milyon"
    return head + (f" {_tr_cardinal(rest)}" if rest else "")


_PL_UNITS = ["zero", "jeden", "dwa", "trzy", "cztery", "pięć", "sześć",
             "siedem", "osiem", "dziewięć", "dziesięć", "jedenaście",
             "dwanaście", "trzynaście", "czternaście", "piętnaście",
             "szesnaście", "siedemnaście", "osiemnaście", "dziewiętnaście"]
_PL_TENS = {20: "dwadzieścia", 30: "trzydzieści", 40: "czterdzieści",
            50: "pięćdziesiąt", 60: "sześćdziesiąt", 70: "siedemdziesiąt",
            80: "osiemdziesiąt", 90: "dziewięćdziesiąt"}
_PL_HUNDREDS = {100: "sto", 200: "dwieście", 300: "trzysta", 400: "czterysta",
                500: "pięćset", 600: "sześćset", 700: "siedemset",
                800: "osiemset", 900: "dziewięćset"}


def _pl_under_1000(n: int) -> str:
    parts = []
    h, rest = divmod(n, 100)
    if h:
        parts.append(_PL_HUNDREDS[h * 100])
    if rest >= 20:
        t, u = divmod(rest, 10)
        parts.append(_PL_TENS[t * 10])
        rest = u
    if rest:
        parts.append(_PL_UNITS[rest])
    return " ".join(parts) if parts else _PL_UNITS[0]


def _pl_plural(n: int, one: str, few: str, many: str) -> str:
    if n == 1:
        return one
    if n % 10 in (2, 3, 4) and n % 100 not in (12, 13, 14):
        return few
    return many


def _pl_cardinal(n: int) -> str:
    if n < 1000:
        return _pl_under_1000(n)
    if n < 1_000_000:
        k, rest = divmod(n, 1000)
        unit = _pl_plural(k, "tysiąc", "tysiące", "tysięcy")
        head = unit if k == 1 else f"{_pl_under_1000(k)} {unit}"
        return head + (f" {_pl_under_1000(rest)}" if rest else "")
    m, rest = divmod(n, 1_000_000)
    unit = _pl_plural(m, "milion", "miliony", "milionów")
    head = unit if m == 1 else f"{_pl_under_1000(m)} {unit}"
    return head + (f" {_pl_cardinal(rest)}" if rest else "")


_HU_UNITS = ["nulla", "egy", "kettő", "három", "négy", "öt", "hat", "hét",
             "nyolc", "kilenc"]
_HU_TENS = {10: "tíz", 20: "húsz", 30: "harminc", 40: "negyven", 50: "ötven",
            60: "hatvan", 70: "hetven", 80: "nyolcvan", 90: "kilencven"}
# tíz/húsz shorten before an attached unit: tizenkettő, huszonegy
_HU_TENS_JOINED = {10: "tizen", 20: "huszon", 30: "harminc", 40: "negyven",
                   50: "ötven", 60: "hatvan", 70: "hetven", 80: "nyolcvan",
                   90: "kilencven"}


def _hu_under_1000(n: int) -> str:
    if n == 0:
        return _HU_UNITS[0]
    parts = []
    h, rest = divmod(n, 100)
    if h:
        parts.append(("" if h == 1 else re.sub(r"kettő$", "két", _HU_UNITS[h])) + "száz")
    if rest:
        t, u = divmod(rest, 10)
        if t and u:
            parts.append(_HU_TENS_JOINED[t * 10] + _HU_UNITS[u])
        elif t:
            parts.append(_HU_TENS[t * 10])
        else:
            parts.append(_HU_UNITS[u])
    return "".join(parts)


def _hu_attr(n: int) -> str:
    """Attributive form before száz/ezer/millió: word-final kettő → két."""
    return re.sub(r"kettő$", "két", _hu_under_1000(n))


def _hu_cardinal(n: int) -> str:
    if n < 1000:
        return _hu_under_1000(n)
    if n < 1_000_000:
        k, rest = divmod(n, 1000)
        head = ("" if k == 1 else _hu_attr(k)) + "ezer"
        # compounds over 2000 are hyphenated in Hungarian orthography
        return head + (("-" + _hu_under_1000(rest)) if rest and n > 2000 else
                       _hu_under_1000(rest) if rest else "")
    m, rest = divmod(n, 1_000_000)
    head = ("egy" if m == 1 else _hu_attr(m)) + "millió"
    return head + (("-" + _hu_cardinal(rest)) if rest else "")


_CARDINALS["tr"] = _tr_cardinal
_CARDINALS["pl"] = _pl_cardinal
_CARDINALS["hu"] = _hu_cardinal
_DECIMAL_WORD["tr"] = "virgül"
_DECIMAL_WORD["pl"] = "przecinek"
_DECIMAL_WORD["hu"] = "egész"
_CURRENCY_WORDS["$"]["tr"] = ("dolar", "dolar")
_CURRENCY_WORDS["$"]["pl"] = ("dolar", "dolary", "dolarów")
_CURRENCY_WORDS["$"]["hu"] = ("dollár", "dollár")
_CURRENCY_WORDS["€"]["tr"] = ("avro", "avro")
_CURRENCY_WORDS["€"]["pl"] = ("euro", "euro", "euro")
_CURRENCY_WORDS["€"]["hu"] = ("euró", "euró")
_CURRENCY_WORDS["£"]["tr"] = ("sterlin", "sterlin")
_CURRENCY_WORDS["£"]["pl"] = ("funt", "funty", "funtów")
_CURRENCY_WORDS["£"]["hu"] = ("font", "font")


# ---------------------------------------------------------------------------
# Czech (Slavic declension like Polish; dvě stě / tři sta / pět set hundreds)
# ---------------------------------------------------------------------------

_CS_UNITS = ["nula", "jedna", "dva", "tři", "čtyři", "pět", "šest", "sedm",
             "osm", "devět", "deset", "jedenáct", "dvanáct", "třináct",
             "čtrnáct", "patnáct", "šestnáct", "sedmnáct", "osmnáct",
             "devatenáct"]
_CS_TENS = {20: "dvacet", 30: "třicet", 40: "čtyřicet", 50: "padesát",
            60: "šedesát", 70: "sedmdesát", 80: "osmdesát", 90: "devadesát"}


def _cs_hundreds(h: int) -> str:
    if h == 1:
        return "sto"
    if h == 2:
        return "dvě stě"
    if h in (3, 4):
        return f"{_CS_UNITS[h]} sta"
    return f"{_CS_UNITS[h]} set"


def _cs_under_1000(n: int) -> str:
    parts = []
    h, rest = divmod(n, 100)
    if h:
        parts.append(_cs_hundreds(h))
    if rest >= 20:
        t, u = divmod(rest, 10)
        parts.append(_CS_TENS[t * 10])
        rest = u
    if rest:
        parts.append(_CS_UNITS[rest])
    return " ".join(parts) if parts else _CS_UNITS[0]


def _cs_cardinal(n: int) -> str:
    if n < 1000:
        return _cs_under_1000(n)
    if n < 1_000_000:
        k, rest = divmod(n, 1000)
        unit = _pl_plural(k, "tisíc", "tisíce", "tisíc")
        head = unit if k == 1 else f"{_cs_under_1000(k)} {unit}"
        return head + (f" {_cs_under_1000(rest)}" if rest else "")
    m, rest = divmod(n, 1_000_000)
    unit = _pl_plural(m, "milion", "miliony", "milionů")
    head = f"{_cs_under_1000(m)} {unit}" if m > 1 else "jeden milion"
    return head + (f" {_cs_cardinal(rest)}" if rest else "")


# ---------------------------------------------------------------------------
# Korean — Sino-Korean cardinals in hangul (만-based grouping like Chinese)
# ---------------------------------------------------------------------------

_KO_DIGITS = ["", "일", "이", "삼", "사", "오", "육", "칠", "팔", "구"]
_KO_SMALL = ["", "십", "백", "천"]


def _ko_under_10000(n: int) -> str:
    if n == 0:
        return "영"
    out = []
    for pos in range(3, -1, -1):
        d = (n // 10 ** pos) % 10
        if d == 0:
            continue
        # 일 is dropped before 십/백/천 (16 = 십육, not 일십육)
        digit = "" if (d == 1 and pos > 0) else _KO_DIGITS[d]
        out.append(digit + _KO_SMALL[pos])
    return "".join(out)


def _ko_cardinal(n: int) -> str:
    if n < 10000:
        return _ko_under_10000(n)
    parts = []
    eok, rest = divmod(n, 10 ** 8)
    man, low = divmod(rest, 10000)
    if eok:
        parts.append((_ko_under_10000(eok) if eok < 10000 else _ko_cardinal(eok)) + "억")
    if man:
        # 일만 keeps its 일 only at the very front by convention; "만" alone
        parts.append(("만" if man == 1 and not eok else _ko_under_10000(man) + "만"))
    if low:
        parts.append(_ko_under_10000(low))
    return "".join(parts)


_CARDINALS["cs"] = _cs_cardinal
_DECIMAL_WORD["cs"] = "celá"
_CURRENCY_WORDS["$"]["cs"] = ("dolar", "dolary", "dolarů")
_CURRENCY_WORDS["€"]["cs"] = ("euro", "eura", "eur")
_CURRENCY_WORDS["£"]["cs"] = ("libra", "libry", "liber")


def expand_numbers_ko(text: str) -> str:
    """Digits → Sino-Korean hangul; decimals digit-by-digit after 점."""

    def _dec(m):
        whole = _ko_cardinal(int(m.group(1)))
        frac = "".join(_KO_DIGITS[int(d)] if d != "0" else "영" for d in m.group(2))
        return f"{whole}점{frac}"

    text = re.sub(r"(\d+)\.(\d+)", _dec, text)
    return re.sub(r"\d+", lambda m: _ko_cardinal(int(m.group(0))), text)


# ---------------------------------------------------------------------------
# Arabic — basic MSA cardinals (masculine agreement) + Arabic-Indic digits
# ---------------------------------------------------------------------------

_AR_INDIC = str.maketrans("٠١٢٣٤٥٦٧٨٩", "0123456789")
_AR_UNITS = ["صفر", "واحد", "اثنان", "ثلاثة", "أربعة", "خمسة", "ستة",
             "سبعة", "ثمانية", "تسعة", "عشرة"]
_AR_TEENS = {11: "أحد عشر", 12: "اثنا عشر"}
_AR_TENS = {20: "عشرون", 30: "ثلاثون", 40: "أربعون", 50: "خمسون",
            60: "ستون", 70: "سبعون", 80: "ثمانون", 90: "تسعون"}
_AR_HUNDREDS = {1: "مئة", 2: "مئتان", 3: "ثلاثمئة", 4: "أربعمئة",
                5: "خمسمئة", 6: "ستمئة", 7: "سبعمئة", 8: "ثمانمئة",
                9: "تسعمئة"}


def _ar_under_100(n: int) -> str:
    if n <= 10:
        return _AR_UNITS[n]
    if n in _AR_TEENS:
        return _AR_TEENS[n]
    if n < 20:
        return f"{_AR_UNITS[n - 10]} عشر"
    t, u = divmod(n, 10)
    tens = _AR_TENS[t * 10]
    # units precede tens joined by و: خمسة وعشرون
    return f"{_AR_UNITS[u]} و{tens}" if u else tens


def _ar_under_1000(n: int) -> str:
    if n < 100:
        return _ar_under_100(n)
    h, rest = divmod(n, 100)
    head = _AR_HUNDREDS[h]
    return f"{head} و{_ar_under_100(rest)}" if rest else head


def _ar_cardinal(n: int) -> str:
    if n < 1000:
        return _ar_under_1000(n)
    if n < 1_000_000:
        k, rest = divmod(n, 1000)
        if k == 1:
            head = "ألف"
        elif k == 2:
            head = "ألفان"
        elif k <= 10:
            head = f"{_AR_UNITS[k]} آلاف"
        else:
            head = f"{_ar_under_1000(k)} ألف"
        return f"{head} و{_ar_under_1000(rest)}" if rest else head
    m, rest = divmod(n, 1_000_000)
    if m == 1:
        head = "مليون"
    elif m == 2:
        head = "مليونان"
    elif m <= 10:
        head = f"{_AR_UNITS[m]} ملايين"
    else:
        head = f"{_ar_under_1000(m)} مليون"
    return f"{head} و{_ar_cardinal(rest)}" if rest else head


_CARDINALS["ar"] = _ar_cardinal
_DECIMAL_WORD["ar"] = "فاصلة"
_CURRENCY_WORDS["$"]["ar"] = ("دولار", "دولارات")
_CURRENCY_WORDS["€"]["ar"] = ("يورو", "يورو")
_CURRENCY_WORDS["£"]["ar"] = ("جنيه", "جنيهات")


def normalize_arabic_indic_digits(text: str) -> str:
    """٠١٢٣٤٥٦٧٨٩ → 0123456789 (run before number expansion)."""
    return text.translate(_AR_INDIC)


# ---------------------------------------------------------------------------
# Japanese — kanji numerals (万-grouping; no 两, and 千/百 drop the leading 一
# below 10000 but 万/億 groups keep it: 一万)
# ---------------------------------------------------------------------------

_JA_DIGITS = "〇一二三四五六七八九"
_JA_SMALL = ["", "十", "百", "千"]


def _ja_under_10000(n: int, keep_ichi: bool = False) -> str:
    if n == 0:
        return "〇"
    out = []
    for pos in range(3, -1, -1):
        d = (n // 10 ** pos) % 10
        if d == 0:
            continue
        drop_one = d == 1 and pos > 0 and not (keep_ichi and pos == 3)
        out.append(("" if drop_one else _JA_DIGITS[d]) + _JA_SMALL[pos])
    return "".join(out)


def ja_number_to_words(n: int) -> str:
    if n < 10000:
        return _ja_under_10000(n)
    parts = []
    oku, rest = divmod(n, 10 ** 8)
    man, low = divmod(rest, 10000)
    if oku:
        head = ja_number_to_words(oku) if oku >= 10000 else _ja_under_10000(oku, keep_ichi=True)
        parts.append(("一" if oku == 1 else head) + "億")
    if man:
        parts.append(("一" if man == 1 else _ja_under_10000(man, keep_ichi=True)) + "万")
    if low:
        parts.append(_ja_under_10000(low))
    return "".join(parts)


def expand_numbers_ja(text: str) -> str:
    """Digits → kanji numerals; decimals digit-by-digit after 点."""

    def _dec(m):
        whole = ja_number_to_words(int(m.group(1)))
        frac = "".join(_JA_DIGITS[int(d)] for d in m.group(2))
        return f"{whole}点{frac}"

    text = re.sub(r"(\d+)\.(\d+)", _dec, text)
    return re.sub(r"\d+", lambda m: ja_number_to_words(int(m.group(0))), text)


# ---------------------------------------------------------------------------
# Hindi (Devanagari) — beyond the reference, which leaves hi at
# basic_cleaners (xtts/tokenizer.py:639)
# ---------------------------------------------------------------------------

_HI_UNITS = (
    "शून्य एक दो तीन चार पाँच छह सात आठ नौ दस ग्यारह बारह तेरह चौदह पंद्रह सोलह "
    "सत्रह अठारह उन्नीस बीस इक्कीस बाईस तेईस चौबीस पच्चीस छब्बीस सत्ताईस अट्ठाईस "
    "उनतीस तीस इकतीस बत्तीस तैंतीस चौंतीस पैंतीस छत्तीस सैंतीस अड़तीस उनतालीस चालीस "
    "इकतालीस बयालीस तैंतालीस चौवालीस पैंतालीस छियालीस सैंतालीस अड़तालीस उनचास पचास "
    "इक्यावन बावन तिरपन चौवन पचपन छप्पन सत्तावन अट्ठावन उनसठ साठ इकसठ बासठ तिरसठ "
    "चौंसठ पैंसठ छियासठ सड़सठ अड़सठ उनहत्तर सत्तर इकहत्तर बहत्तर तिहत्तर चौहत्तर पचहत्तर "
    "छिहत्तर सतहत्तर अठहत्तर उनासी अस्सी इक्यासी बयासी तिरासी चौरासी पचासी छियासी "
    "सत्तासी अट्ठासी नवासी नब्बे इक्यानवे बानवे तिरानवे चौरानवे पचानवे छियानवे "
    "सत्तानवे अट्ठानवे निन्यानवे"
).split()


def hi_number_to_words(n: int) -> str:
    """Indian numbering system: सौ (100), हज़ार (1e3), लाख (1e5), करोड़ (1e7)."""
    if n < 0:
        return "माइनस " + hi_number_to_words(-n)
    if n < 100:
        return _HI_UNITS[n]
    parts = []
    for value, name in ((10**7, "करोड़"), (10**5, "लाख"), (10**3, "हज़ार"), (100, "सौ")):
        if n >= value:
            parts.append(hi_number_to_words(n // value) + " " + name)
            n %= value
    if n:
        parts.append(_HI_UNITS[n])
    return " ".join(parts)


_HI_DIGITS_MAP = {ord("०") + i: str(i) for i in range(10)}


def expand_numbers_hi(text: str) -> str:
    """Devanagari/ASCII digits → Hindi words; decimals digit-by-digit."""
    text = text.translate(_HI_DIGITS_MAP)

    def _dec(m):
        whole = hi_number_to_words(int(m.group(1)))
        frac = " ".join(_HI_UNITS[int(d)] for d in m.group(2))
        return f"{whole} दशमलव {frac}"

    text = re.sub(r"(\d+)\.(\d+)", _dec, text)
    return re.sub(r"\d+", lambda m: hi_number_to_words(int(m.group(0))), text)


_JA_KANA_DIGITS = ["ゼロ", "いち", "に", "さん", "よん", "ご", "ろく", "なな", "はち", "きゅう"]


def ja_number_to_kana(n: int) -> str:
    """Number → kana reading (covers the standard sound changes:
    さんびゃく/ろっぴゃく/はっぴゃく, さんぜん/はっせん, じゅう elision)."""
    if n < 0:
        return "マイナス" + ja_number_to_kana(-n)
    if n < 10:
        return _JA_KANA_DIGITS[n]
    parts = []
    man, rest = divmod(n, 10000)
    if man:
        parts.append(("いち" if man == 1 else ja_number_to_kana(man)) + "まん")
    sen, rest = divmod(rest, 1000)
    if sen:
        head = {1: "", 3: "さん", 8: "はっ"}.get(sen, _JA_KANA_DIGITS[sen])
        parts.append(head + ("ぜん" if sen == 3 else "せん"))
    hyaku, rest = divmod(rest, 100)
    if hyaku:
        if hyaku == 3:
            parts.append("さんびゃく")
        elif hyaku == 6:
            parts.append("ろっぴゃく")
        elif hyaku == 8:
            parts.append("はっぴゃく")
        else:
            parts.append(("" if hyaku == 1 else _JA_KANA_DIGITS[hyaku]) + "ひゃく")
    ju, rest = divmod(rest, 10)
    if ju:
        parts.append(("" if ju == 1 else _JA_KANA_DIGITS[ju]) + "じゅう")
    if rest:
        parts.append(_JA_KANA_DIGITS[rest])
    return "".join(parts)


def expand_numbers_ja_kana(text: str) -> str:
    """Digits → kana readings (used when no morphological analyzer can
    read kanji numerals back)."""

    def _dec(m):
        whole = ja_number_to_kana(int(m.group(1)))
        frac = "".join(_JA_KANA_DIGITS[int(d)] for d in m.group(2))
        return f"{whole}てん{frac}"

    text = re.sub(r"(\d+)\.(\d+)", _dec, text)
    return re.sub(r"\d+", lambda m: ja_number_to_kana(int(m.group(0))), text)
