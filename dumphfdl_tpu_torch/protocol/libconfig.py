# Copy of dumphfdl_tpu/protocol/libconfig.py: equal to it below this line, the citations' absolute path to the reference tree read as 'reference ' (tests/test_torch_hostcopies.py).
"""Minimal libconfig parser (tokenizer + recursive descent).

Covers the grammar subset the reference uses through libconfig for the
system table (reference src/systable.c:168-188, etc/systable.conf):

  config     := setting*
  setting    := NAME ('='|':') value (';'|',')?
  value      := scalar | group | list | array
  group      := '{' setting* '}'
  list       := '(' (value (',' value)*)? ')'
  array      := '[' (scalar (',' scalar)*)? ']'
  scalar     := int | int64 | hex | float | bool | string+

plus the three libconfig comment styles (// ... , # ... , /* ... */) and
adjacent-string concatenation.  Unlike the previous regex scraper this
rejects malformed input loudly (LibconfigError with a line number) and
handles nested groups/lists and comments correctly.
"""

from __future__ import annotations

import re

__all__ = ['LibconfigError', 'loads', 'dumps']


class LibconfigError(ValueError):
    """Raised on malformed libconfig input (with 1-based line number)."""

    def __init__(self, msg: str, line: int):
        super().__init__(f'line {line}: {msg}')
        self.line = line


_TOKEN_RE = re.compile(r'''
    (?P<ws>[ \t\r]+)
  | (?P<nl>\n)
  | (?P<comment>//[^\n]*|\#[^\n]*)
  | (?P<blockcomment>/\*.*?\*/)
  | (?P<string>"(?:[^"\\\n]|\\.)*")
  | (?P<float>[-+]?(?:\d+\.\d*|\.\d+)(?:[eE][-+]?\d+)?|[-+]?\d+[eE][-+]?\d+)
  | (?P<hex>0[xX][0-9a-fA-F]+L{0,2})
  | (?P<int>[-+]?\d+L{0,2})
  | (?P<name>[A-Za-z*][-A-Za-z0-9_*.]*)
  | (?P<punct>[={}()\[\];:,])
''', re.VERBOSE | re.DOTALL)

_ESCAPES = {'n': '\n', 't': '\t', 'r': '\r', '\\': '\\', '"': '"', 'f': '\f'}


def _unescape(s: str) -> str:
    out, i = [], 0
    while i < len(s):
        ch = s[i]
        if ch == '\\' and i + 1 < len(s):
            nxt = s[i + 1]
            if nxt == 'x' and i + 3 < len(s):
                out.append(chr(int(s[i + 2:i + 4], 16)))
                i += 4
                continue
            out.append(_ESCAPES.get(nxt, nxt))
            i += 2
            continue
        out.append(ch)
        i += 1
    return ''.join(out)


def _tokenize(text: str) -> list[tuple[str, str, int]]:
    tokens: list[tuple[str, str, int]] = []
    pos, line = 0, 1
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise LibconfigError(f'unexpected character {text[pos]!r}', line)
        kind = m.lastgroup
        val = m.group()
        if kind == 'nl':
            line += 1
        elif kind in ('ws', 'comment'):
            pass
        elif kind == 'blockcomment':
            line += val.count('\n')
        else:
            tokens.append((kind, val, line))
        pos = m.end()
    tokens.append(('eof', '', line))
    return tokens


class _Parser:
    def __init__(self, tokens: list[tuple[str, str, int]]):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, kind: str, val: str | None = None):
        k, v, line = self.next()
        if k != kind or (val is not None and v != val):
            want = val if val is not None else kind
            raise LibconfigError(f'expected {want!r}, got {v!r}', line)
        return v, line

    def parse_config(self) -> dict:
        out: dict = {}
        while self.peek()[0] != 'eof':
            self.parse_setting(out)
        return out

    def parse_setting(self, out: dict) -> None:
        k, name, line = self.next()
        if k != 'name':
            raise LibconfigError(f'expected setting name, got {name!r}', line)
        k, v, line = self.next()
        if not (k == 'punct' and v in '=:'):
            raise LibconfigError(f"expected '=' after {name!r}, got {v!r}", line)
        value = self.parse_value()
        if name in out:
            raise LibconfigError(f'duplicate setting {name!r}', line)
        out[name] = value
        # scalar settings require a terminator; after aggregates it is optional
        k, v, _ = self.peek()
        if k == 'punct' and v in ';,':
            self.next()
        elif not isinstance(value, (dict, list, tuple)):
            raise LibconfigError(f"missing ';' after setting {name!r}", line)

    def parse_value(self):
        k, v, line = self.peek()
        if k == 'punct' and v == '{':
            return self.parse_group()
        if k == 'punct' and v == '(':
            return self.parse_list()
        if k == 'punct' and v == '[':
            return self.parse_array()
        return self.parse_scalar()

    def parse_group(self) -> dict:
        self.expect('punct', '{')
        out: dict = {}
        while True:
            k, v, line = self.peek()
            if k == 'punct' and v == '}':
                self.next()
                return out
            if k == 'eof':
                raise LibconfigError("unterminated '{' group", line)
            self.parse_setting(out)

    def _parse_seq(self, close: str, scalars_only: bool) -> list:
        self.next()  # opening bracket
        out: list = []
        while True:
            k, v, line = self.peek()
            if k == 'punct' and v == close:
                self.next()
                return out
            if k == 'eof':
                raise LibconfigError(f"unterminated {close!r} sequence", line)
            if out:
                self.expect('punct', ',')
                k, v, line = self.peek()
                if k == 'punct' and v == close:   # allow trailing comma
                    self.next()
                    return out
            item = self.parse_scalar() if scalars_only else self.parse_value()
            out.append(item)

    def parse_list(self) -> list:
        return self._parse_seq(')', scalars_only=False)

    def parse_array(self) -> list:
        return self._parse_seq(']', scalars_only=True)

    def parse_scalar(self):
        k, v, line = self.next()
        if k == 'string':
            s = _unescape(v[1:-1])
            while self.peek()[0] == 'string':   # adjacent-string concat
                s += _unescape(self.next()[1][1:-1])
            return s
        if k == 'float':
            return float(v)
        if k == 'hex':
            return int(v.rstrip('L'), 16)
        if k == 'int':
            return int(v.rstrip('L'))
        if k == 'name' and v in ('true', 'false', 'TRUE', 'FALSE', 'True', 'False'):
            return v.lower() == 'true'
        raise LibconfigError(f'expected a value, got {v!r}', line)


def loads(text: str) -> dict:
    """Parse libconfig text into nested dict/list/scalar values."""
    return _Parser(_tokenize(text)).parse_config()


def _dump_value(v, indent: int) -> str:
    pad = '  ' * indent
    if isinstance(v, bool):
        return 'true' if v else 'false'
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        s = repr(v)
        return s if ('.' in s or 'e' in s or 'inf' in s or 'nan' in s) else s + '.0'
    if isinstance(v, str):
        esc = v.replace('\\', '\\\\').replace('"', '\\"')
        return f'"{esc}"'
    if isinstance(v, dict):
        inner = ''.join(f'{pad}  {k} = {_dump_value(x, indent + 1)};\n'
                        for k, x in v.items())
        return '{\n' + inner + pad + '}'
    if isinstance(v, (list, tuple)):
        items = ', '.join(_dump_value(x, indent + 1) for x in v)
        return f'( {items} )'
    raise TypeError(f'cannot serialize {type(v).__name__}')


def dumps(cfg: dict) -> str:
    """Serialize a nested dict back to libconfig text (round-trips loads)."""
    return ''.join(f'{k} = {_dump_value(v, 0)};\n' for k, v in cfg.items())
