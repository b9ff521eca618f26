"""Typed CLI option registry.

Behavioral rebuild of the reference's OptionsManager
(tools/options.hpp:247-545): typed options with categories, int
ranges, string allowed-sets whose index doubles as the enum value
(tools/akoenc.cpp:440-446), auto-generated help, and strict
unknown-flag / missing-value errors. ako_tpu/tools/options.py's code,
copied because importing ako_tpu imports JAX."""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict, List, Optional, Sequence, Union


class OptionError(Exception):
    pass


@dataclasses.dataclass
class IntOption:
    name: str
    default: int
    minimum: int
    maximum: int
    category: str
    help: str
    long_name: str = ""
    value: int = 0

    def __post_init__(self):
        self.value = self.default

    def parse(self, raw: str) -> None:
        try:
            v = int(raw, 0)
        except ValueError:
            raise OptionError(f"'{raw}' is not a valid integer for '{self.name}'")
        if v < self.minimum or v > self.maximum:
            raise OptionError(
                f"value for '{self.name}' out of range "
                f"[{self.minimum}, {self.maximum}]"
            )
        self.value = v


@dataclasses.dataclass
class StringOption:
    name: str
    default: str
    allowed: Optional[Sequence[str]]
    category: str
    help: str
    long_name: str = ""
    value: str = ""

    def __post_init__(self):
        self.value = self.default

    def parse(self, raw: str) -> None:
        if self.allowed is not None and raw.upper() not in [
            a.upper() for a in self.allowed
        ]:
            raise OptionError(
                f"'{raw}' is not a valid value for '{self.name}' "
                f"(allowed: {', '.join(self.allowed)})"
            )
        self.value = raw

    @property
    def index(self) -> int:
        """Index in the allowed set — doubles as the enum value."""
        assert self.allowed is not None
        return [a.upper() for a in self.allowed].index(self.value.upper())


@dataclasses.dataclass
class BoolOption:
    name: str
    category: str
    help: str
    long_name: str = ""
    value: bool = False

    def parse(self, raw: str) -> None:  # presence flag; no argument
        self.value = True


Option = Union[IntOption, StringOption, BoolOption]


class OptionsManager:
    def __init__(self, program: str, summary: str = ""):
        self.program = program
        self.summary = summary
        self._by_name: Dict[str, Option] = {}
        self._order: List[Option] = []

    def add(self, opt: Option) -> Option:
        self._by_name[opt.name] = opt
        if opt.long_name:
            self._by_name[opt.long_name] = opt
        self._order.append(opt)
        return opt

    def add_int(self, name, default, minimum, maximum, category, help="", long_name=""):
        return self.add(
            IntOption(name, default, minimum, maximum, category, help, long_name)
        )

    def add_string(self, name, default, allowed, category, help="", long_name=""):
        return self.add(
            StringOption(name, default, allowed, category, help, long_name)
        )

    def add_bool(self, name, category, help="", long_name=""):
        return self.add(BoolOption(name, category, help, long_name))

    def parse_arguments(self, argv: Sequence[str]) -> None:
        i = 0
        while i < len(argv):
            arg = argv[i]
            opt = self._by_name.get(arg)
            if opt is None:
                raise OptionError(f"unknown option '{arg}'")
            if isinstance(opt, BoolOption):
                opt.parse("")
            else:
                if i + 1 >= len(argv):
                    raise OptionError(f"missing value for '{arg}'")
                i += 1
                opt.parse(argv[i])
            i += 1

    def __getitem__(self, name: str) -> Option:
        return self._by_name[name]

    def print_help(self, file=sys.stdout) -> None:
        print(f"usage: {self.program} [options]", file=file)
        if self.summary:
            print(self.summary, file=file)
        by_cat: Dict[str, List[Option]] = {}
        for o in self._order:
            by_cat.setdefault(o.category, []).append(o)
        for cat, opts in by_cat.items():
            print(f"\n{cat}:", file=file)
            for o in opts:
                if isinstance(o, IntOption):
                    extra = f" (int {o.minimum}..{o.maximum}, default {o.default})"
                elif isinstance(o, StringOption):
                    allowed = f" one of {', '.join(o.allowed)};" if o.allowed else ""
                    extra = f" ({allowed} default {o.default})"
                else:
                    extra = ""
                print(f"  {o.name:<18} {o.help}{extra}", file=file)
