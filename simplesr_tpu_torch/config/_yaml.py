"""A YAML reader and writer for the subset that the repo's configs use, in
place of PyYAML (which the GPU machine lacks).

The subset: block mappings and block sequences (a sequence item may open a
mapping, ``- loss_function: MeanSquaredError``), one-line flow sequences,
comments, the ``!!python/tuple`` tag on a sequence, and plain, single- and
double-quoted scalars. Plain scalars resolve as PyYAML's ``SafeLoader``
resolves them, which is YAML 1.1: ``1.0e-4`` is a float but ``1e-4`` and
``1.0e4`` are strings; ``yes``/``no``/``on``/``off`` are booleans; ``~``,
``null`` and an empty value are None; a leading ``0`` is octal, ``0x`` hex,
``0b`` binary, and ``1:30`` base 60. Anything else (flow mappings, anchors,
aliases, block scalars, other tags, multi-line scalars, documents,
timestamps) raises ``YAMLError`` with its line number: the reader never
guesses.
"""

import json
import math
import re

__all__ = ["YAMLError", "load", "loads", "dump"]

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                  |[-+]?0[0-7_]+
                  |[-+]?(?:0|[1-9][0-9_]*)
                  |[-+]?0x[0-9a-fA-F_]+
                  |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
# resolved by PyYAML to types outside the subset (dates, merge keys, '=')
_UNSUPPORTED = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                          (?:(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9]
                          (?:\.[0-9]*)?(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)?
                          |<<|=)$""", re.X)
_TUPLE_TAG = "!!python/tuple"
_DOUBLE_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n",
                   "v": "\v", "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
                   "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": "\u2028",
                   "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class YAMLError(ValueError):
    """A document outside the subset, or malformed, with its line number."""

    def __init__(self, message, line):
        super().__init__(f"line {line}: {message}")
        self.line = line


# ---------------------------------------------------------------- scalars

def _sexagesimal(parts, cast):
    value = cast(0)
    for part in parts:
        value = value * 60 + cast(part)
    return value


def _to_int(text):
    value = text.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal(value.split(":"), int)
    return sign * int(value)


def _to_float(text):
    value = text.replace("_", "").lower()
    sign = -1.0 if value[0] == "-" else 1.0
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * _sexagesimal(value.split(":"), float)
    return sign * float(value)


def resolve_plain(text, line=0):
    """A plain (unquoted) scalar as SafeLoader resolves it."""
    if _UNSUPPORTED.match(text):
        raise YAMLError(f"plain scalar {text!r} resolves to a type outside the subset", line)
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _INT.match(text):
        return _to_int(text)
    if _FLOAT.match(text):
        return _to_float(text)
    return text


def _single_quoted(text, line):
    """``text`` starts with ``'``: the scalar and the rest after it."""
    out, i = [], 1
    while i < len(text):
        if text[i] == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1:]
        out.append(text[i])
        i += 1
    raise YAMLError("unterminated single-quoted scalar (multi-line scalars are "
                    "outside the subset)", line)


def _double_quoted(text, line):
    out, i = [], 1
    while i < len(text):
        c = text[i]
        if c == '"':
            return "".join(out), text[i + 1:]
        if c == "\\":
            esc = text[i + 1:i + 2]
            if esc in _DOUBLE_ESCAPES:
                out.append(_DOUBLE_ESCAPES[esc])
                i += 2
                continue
            if esc in _HEX_ESCAPES:
                digits = text[i + 2:i + 2 + _HEX_ESCAPES[esc]]
                if len(digits) != _HEX_ESCAPES[esc] or not re.fullmatch(r"[0-9a-fA-F]+", digits):
                    raise YAMLError(f"bad escape \\{esc}{digits}", line)
                out.append(chr(int(digits, 16)))
                i += 2 + len(digits)
                continue
            raise YAMLError(f"escape \\{esc} is outside the subset", line)
        out.append(c)
        i += 1
    raise YAMLError("unterminated double-quoted scalar (multi-line scalars are "
                    "outside the subset)", line)


def _quoted(text, line):
    return (_single_quoted if text[0] == "'" else _double_quoted)(text, line)


# ------------------------------------------------------------------- lines

def _starts_token(before):
    """Whether a quote after ``before`` opens a quoted scalar."""
    stripped = before.rstrip()
    if not stripped:
        return True
    if stripped[-1] in "[,":
        return True
    return before[-1:] in (" ", "\t") and stripped[-1] in ":-"


def _strip_comment(text):
    quote, i = None, 0
    while i < len(text):
        c = text[i]
        if quote == "'":
            if c == "'":
                if text[i + 1:i + 2] == "'":
                    i += 2
                    continue
                quote = None
        elif quote == '"':
            if c == "\\":
                i += 2
                continue
            if c == '"':
                quote = None
        elif c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        elif c in "'\"" and _starts_token(text[:i]):
            quote = c
        i += 1
    return text.rstrip()


def _lines(source):
    """(line number, indent, content) of each line that holds content."""
    out = []
    for number, raw in enumerate(source.splitlines(), 1):
        body = raw.lstrip(" ")
        if body.startswith("\t") and body.strip():
            raise YAMLError("tabs in indentation", number)
        content = _strip_comment(body)
        if not content:
            continue
        if content.startswith(("---", "...", "%")) and (len(content) == 3 or content[3:4] in " \t"
                                                       or content[0] == "%"):
            raise YAMLError("document markers and directives are outside the subset", number)
        out.append((number, len(raw) - len(body), content))
    return out


def _split_key(content, line):
    """``key: value`` -> (key text, value text), or None for a line that is
    not a mapping entry. The separator is the first ``:`` followed by a
    space or the end, outside quotes and brackets."""
    if content[0] in "'\"":
        key, rest = _quoted(content, line)
        stripped = rest.lstrip(" ")
        if stripped.startswith(":") and (len(stripped) == 1 or stripped[1] in " \t"):
            return content[:len(content) - len(rest)], stripped[1:].strip()
        return None
    if content[0] in "[{":
        return None
    for i, c in enumerate(content):
        if c == ":" and (i + 1 == len(content) or content[i + 1] in " \t"):
            return content[:i].rstrip(), content[i + 1:].strip()
    return None


def _is_sequence_item(content):
    return content == "-" or content.startswith(("- ", "-\t"))


# ------------------------------------------------------------------ parser

class _Parser:
    def __init__(self, source):
        self.lines = _lines(source)

    def parse(self):
        if not self.lines:
            return None
        _, indent, _ = self.lines[0]
        value, i = self.block(0, indent)
        if i < len(self.lines):
            raise YAMLError("unexpected content after the document's top level", self.lines[i][0])
        return value

    def block(self, i, indent):
        if _is_sequence_item(self.lines[i][2]):
            return self.sequence(i, indent)
        return self.mapping(i, indent)

    def nested(self, i, parent_indent, allow_same_indent_sequence):
        """The block after a key or item whose value was empty: None when no
        line is indented further (or, for a key, opens a sequence at the
        key's own indent, which YAML allows)."""
        if i < len(self.lines):
            _, indent, content = self.lines[i]
            if indent > parent_indent:
                return self.block(i, indent)
            if allow_same_indent_sequence and indent == parent_indent and \
                    _is_sequence_item(content):
                return self.sequence(i, indent)
        return None, i

    def mapping(self, i, indent):
        out = {}
        while i < len(self.lines):
            number, ind, content = self.lines[i]
            if ind < indent:
                break
            if ind > indent:
                raise YAMLError("bad indentation of a mapping entry", number)
            if _is_sequence_item(content):
                raise YAMLError("a sequence item where a mapping entry was expected", number)
            split = _split_key(content, number)
            if split is None:
                raise YAMLError(f"expected 'key: value', got {content!r} (multi-line "
                                "scalars are outside the subset)", number)
            key = self.scalar(split[0], number)
            if isinstance(key, (list, dict)):
                raise YAMLError("complex keys are outside the subset", number)
            value, i = self.value(split[1], i, indent, number, key_context=True)
            out[key] = value
        return out, i

    def sequence(self, i, indent):
        out = []
        while i < len(self.lines):
            number, ind, content = self.lines[i]
            if ind < indent:
                break
            if ind > indent:
                raise YAMLError("bad indentation of a sequence item", number)
            if not _is_sequence_item(content):
                break
            rest = content[1:]
            item = rest.lstrip(" \t")
            if not item:
                value, i = self.nested(i + 1, indent, False)
            elif _is_sequence_item(item) or _split_key(item, number) is not None:
                # the item opens a block at its own column: re-read this line there
                column = ind + len(content) - len(item)
                self.lines[i] = (number, column, item)
                value, i = self.block(i, column)
            else:
                value, i = self.value(item, i, indent, number, key_context=False)
            out.append(value)
        return out, i

    def value(self, text, i, indent, number, key_context):
        """An entry's value from its inline ``text`` (and, when that is
        empty or a bare tag, the block below). Returns (value, next line)."""
        if text.startswith("!"):
            tag, _, text = text.partition(" ")
            if tag != _TUPLE_TAG:
                raise YAMLError(f"tag {tag} is outside the subset", number)
            text = text.strip()
            if not text:
                seq, i = self.nested(i + 1, indent, key_context)
                if not isinstance(seq, list):
                    raise YAMLError(f"{_TUPLE_TAG} on something other than a sequence", number)
                return tuple(seq), i
            seq = self.scalar(text, number)
            if not isinstance(seq, list):
                raise YAMLError(f"{_TUPLE_TAG} on something other than a sequence", number)
            return tuple(seq), i + 1
        if not text:
            return self.nested(i + 1, indent, key_context)
        return self.scalar(text, number), i + 1

    def scalar(self, text, number):
        """One inline node: a flow sequence, a quoted or a plain scalar."""
        if text[0] in "&*|>{%@`!?":
            raise YAMLError(f"{text[0]!r} (anchors, aliases, block scalars, flow mappings, "
                            "tags, complex keys) is outside the subset", number)
        if text[0] == "[":
            value, rest = self.flow_sequence(text, number)
        elif text[0] in "'\"":
            value, rest = _quoted(text, number)
        else:
            if ": " in text or text.endswith(":"):
                raise YAMLError(f"{text!r}: a mapping inside a plain scalar", number)
            return resolve_plain(text, number)
        if rest.strip():
            raise YAMLError(f"unexpected {rest.strip()!r} after a scalar", number)
        return value

    def flow_sequence(self, text, number):
        """``text`` starts with ``[``: the list and the rest after ``]``."""
        out, rest = [], text[1:].lstrip()
        while True:
            if not rest:
                raise YAMLError("unterminated flow sequence (multi-line flow "
                                "sequences are outside the subset)", number)
            if rest[0] == "]":
                return out, rest[1:]
            if rest[0] == "[":
                value, rest = self.flow_sequence(rest, number)
            elif rest[0] in "'\"":
                value, rest = _quoted(rest, number)
            elif rest[0] in "&*|>{%@`!?,":
                raise YAMLError(f"{rest[0]!r} in a flow sequence is outside the subset", number)
            else:
                end = re.search(r"[,\]]", rest)
                if end is None:
                    raise YAMLError("unterminated flow sequence", number)
                plain = rest[:end.start()].strip()
                if ": " in plain or plain.endswith(":"):
                    raise YAMLError("mappings in a flow sequence are outside the subset", number)
                value, rest = resolve_plain(plain, number), rest[end.start():]
            out.append(value)
            rest = rest.lstrip()
            if rest.startswith(","):
                rest = rest[1:].lstrip()
            elif not rest.startswith("]"):
                raise YAMLError(f"expected ',' or ']' in a flow sequence, got {rest!r}", number)


def loads(source):
    """Parse a YAML document of the subset."""
    return _Parser(source).parse()


def load(path):
    with open(path) as f:
        return loads(f.read())


# ------------------------------------------------------------------ writer

def _dump_scalar(value):
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        mantissa, e, exponent = text.partition("e")
        if "." not in mantissa:
            mantissa += ".0"
        if e and exponent[0] not in "+-":
            exponent = "+" + exponent
        return mantissa + (f"e{exponent}" if e else "")
    if isinstance(value, str):
        return json.dumps(value)  # a double-quoted YAML scalar
    raise TypeError(f"cannot write {type(value).__name__} as YAML")


def _dump_flow(values):
    parts = [_dump_flow(v) if isinstance(v, (list, tuple)) else _dump_scalar(v) for v in values]
    return "[" + ", ".join(parts) + "]"


def _dump_block(value, indent):
    pad = " " * indent
    lines = []
    if isinstance(value, dict):
        for key, item in value.items():
            head = f"{pad}{_dump_scalar(key)}:"
            if isinstance(item, dict) and item:
                lines += [head] + _dump_block(item, indent + 2)
            elif isinstance(item, list) and item and any(isinstance(v, dict) for v in item):
                lines += [head] + _dump_block(item, indent + 2)
            else:
                lines.append(f"{head} {_dump_inline(item)}")
    else:
        for item in value:
            if isinstance(item, dict) and item:
                first, *rest = _dump_block(item, indent + 2)
                lines += [f"{pad}- {first.lstrip()}"] + rest
            else:
                lines.append(f"{pad}- {_dump_inline(item)}")
    return lines


def _dump_inline(value):
    if isinstance(value, tuple):
        return f"{_TUPLE_TAG} {_dump_flow(value)}"
    if isinstance(value, list):
        return _dump_flow(value)
    if isinstance(value, dict):
        raise TypeError("an empty mapping or a mapping inside a flow sequence is outside "
                        "the subset")
    return _dump_scalar(value)


def dump(data):
    """A document of the subset that ``loads`` reads back equal to ``data``
    (dicts, lists, tuples, str, int, float, bool, None)."""
    if not isinstance(data, (dict, list)):
        return _dump_inline(data) + "\n"
    return "\n".join(_dump_block(data, 0)) + "\n"
