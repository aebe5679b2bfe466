"""Command-line interface package — ≙ the reference's `packages/cli/`
(command_spec.pony, command_parser.pony, command.pony, command_help.pony,
env_vars.pony).

Typed option/arg specs with defaults, short names, sub-commands, an
auto-generated `help` command, environment-variable fallback, and a
parser that reports errors as values (SyntaxError-style strings), not
exceptions — matching the reference's `(Command | CommandHelp |
SyntaxError)` result union.

    spec = CommandSpec.parent("tool", "My tool", options=[
        OptionSpec.bool("verbose", "Noisy output", short="v",
                        default=False)])
    spec.add_command(CommandSpec.leaf("run", "Run it", args=[
        ArgSpec.string("target", "What to run")]))
    spec.add_help()
    cmd = CommandParser(spec).parse(["tool", "run", "x"])  # or CommandHelp
                                                           # or CliSyntaxError
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

__all__ = ["CommandSpec", "OptionSpec", "ArgSpec", "Command", "CommandHelp",
           "CliSyntaxError", "CommandParser", "EnvVars"]


class CliSyntaxError:
    """A parse failure as a *value* (≙ cli's SyntaxError class — Pony
    returns it from parse rather than raising)."""

    def __init__(self, token: str, msg: str):
        self.token = token
        self.msg = msg

    def string(self) -> str:
        return f"Error: {self.msg} at: '{self.token}'"

    def __repr__(self):
        return self.string()


class _Spec:
    def __init__(self, name: str, descr: str, typ: str, default: Any,
                 required: bool, short: Optional[str]):
        if not name or not name[0].isalpha():
            raise ValueError(f"invalid name {name!r}")  # ≙ _assertName
        self.name = name
        self.descr = descr
        self.typ = typ                  # bool | string | i64 | u64 | f64 |
        #                                 string_seq
        self.default = default
        self.required = required
        self.short = short

    def _convert(self, raw: str):
        if self.typ == "bool":
            if raw.lower() in ("true", "1", ""):
                return True
            if raw.lower() in ("false", "0"):
                return False
            raise ValueError(f"invalid bool {raw!r}")
        if self.typ in ("i64", "u64"):
            v = int(raw, 0)
            if self.typ == "u64" and v < 0:
                raise ValueError(f"negative value {raw!r} for u64")
            return v
        if self.typ == "f64":
            return float(raw)
        return raw


def _make_ctors(cls, seq_types=("string_seq",)):
    # As in the reference (command_spec.pony bool/string/i64/u64/f64
    # constructors take `default': (A | None) = None`): omitting the
    # default makes the option/arg REQUIRED; pass default= to make it
    # optional.
    for typ in ("bool", "string", "i64", "u64", "f64"):
        def ctor(name, descr="", short=None, default=None, required=False,
                 _t=typ):
            return cls(name, descr, _t, default,
                       required or default is None, short)
        setattr(cls, typ, staticmethod(ctor))
    for typ in seq_types:
        def seq_ctor(name, descr="", short=None, _t=typ):
            return cls(name, descr, _t, (), False, short)
        setattr(cls, typ, staticmethod(seq_ctor))


class OptionSpec(_Spec):
    """≙ command_spec.pony OptionSpec: typed --name/-s option."""

    def requires_arg(self) -> bool:
        return self.typ != "bool"

    def help_string(self) -> str:
        s = f"-{self.short}, " if self.short else "    "
        s += f"--{self.name}"
        if self.requires_arg():
            s += "=<" + self.typ + ">"
        return f"  {s:28s} {self.descr}"


class ArgSpec(_Spec):
    """≙ command_spec.pony ArgSpec: typed positional argument."""

    def __init__(self, name, descr, typ, default, required, short=None):
        super().__init__(name, descr, typ, default, required, None)

    def help_string(self) -> str:
        return f"  <{self.name}:{self.typ}>  {self.descr}"


_make_ctors(OptionSpec)
_make_ctors(ArgSpec)


class CommandSpec:
    """≙ command_spec.pony CommandSpec: a leaf takes args; a parent takes
    sub-commands. `add_help()` installs the auto help command/option."""

    def __init__(self, name: str, descr: str, options: Sequence[OptionSpec],
                 is_leaf: bool, args: Sequence[ArgSpec] = ()):
        if not name or not all(c.isalnum() or c in "-_" for c in name):
            raise ValueError(f"invalid command name {name!r}")
        self.name_ = name
        self.descr_ = descr
        self.options_: Dict[str, OptionSpec] = {o.name: o for o in options}
        self.commands_: Dict[str, CommandSpec] = {}
        self.args_: List[ArgSpec] = list(args)
        self._leaf = is_leaf
        self._help_name: Optional[str] = None

    # -- constructors (≙ new parent / new leaf) --
    @classmethod
    def parent(cls, name: str, descr: str = "",
               options: Sequence[OptionSpec] = (),
               commands: Sequence["CommandSpec"] = ()) -> "CommandSpec":
        s = cls(name, descr, options, is_leaf=False)
        for c in commands:
            s.add_command(c)
        return s

    @classmethod
    def leaf(cls, name: str, descr: str = "",
             options: Sequence[OptionSpec] = (),
             args: Sequence[ArgSpec] = ()) -> "CommandSpec":
        return cls(name, descr, options, is_leaf=True, args=args)

    def add_command(self, cmd: "CommandSpec") -> None:
        if self._leaf:
            raise ValueError("cannot add a sub-command to a leaf")
        self.commands_[cmd.name_] = cmd

    def add_help(self, hname: str = "help", descr: str = "") -> None:
        self._help_name = hname
        self.options_[hname] = OptionSpec.bool(
            hname, descr or "Print help and exit", short="h", default=False)
        if not self._leaf:
            self.commands_[hname] = CommandSpec.leaf(
                hname, descr or "Print help for a command",
                args=[ArgSpec.string("command", "", default="")])

    def is_leaf(self) -> bool:
        return self._leaf

    def is_parent(self) -> bool:
        return not self._leaf

    def name(self) -> str:
        return self.name_

    def descr(self) -> str:
        return self.descr_

    def help_string(self) -> str:
        parts = [self.name_]
        if self.options_:
            parts.append("[<options>]")
        if self.commands_:
            parts.append("<command>")
        for a in self.args_:
            parts.append(f"<{a.name}>")
        return " ".join(parts)


class Command:
    """A successfully parsed invocation (≙ command.pony): full_name is
    "tool/sub"; options and args are name→typed-value dicts."""

    def __init__(self, spec: CommandSpec, full_name: str,
                 options: Dict[str, Any], args: Dict[str, Any]):
        self.spec = spec
        self._full = full_name
        self.options = options
        self.args = args

    def full_name(self) -> str:
        return self._full

    def option(self, name: str):
        return self.options[name]

    def arg(self, name: str):
        return self.args[name]


class CommandHelp:
    """≙ command_help.pony: renders usage/options/commands for a spec."""

    def __init__(self, spec: CommandSpec, path: List[CommandSpec]):
        self.spec = spec
        self.path = path

    def help_string(self) -> str:
        lines = ["usage: " + " ".join(
            s.help_string() for s in self.path + [self.spec])]
        if self.spec.descr_:
            lines += ["", self.spec.descr_]
        if self.spec.options_:
            lines += ["", "Options:"]
            lines += [o.help_string() for o in self.spec.options_.values()]
        if self.spec.commands_:
            lines += ["", "Commands:"]
            lines += [f"  {c.name_:16s} {c.descr_}"
                      for c in self.spec.commands_.values()]
        if self.spec.args_:
            lines += ["", "Args:"]
            lines += [a.help_string() for a in self.spec.args_]
        return "\n".join(lines) + "\n"


class EnvVars:
    """≙ env_vars.pony: TOOL_OPTNAME=value environment fallback for
    options not given on the command line."""

    def __init__(self, env: Dict[str, str], prefix: str = ""):
        self.env = env
        self.prefix = prefix

    def lookup(self, cmd_name: str, opt_name: str) -> Optional[str]:
        key = (self.prefix or cmd_name).upper() + "_" + \
            opt_name.upper().replace("-", "_")
        return self.env.get(key)


class CommandParser:
    """≙ command_parser.pony: returns Command | CommandHelp |
    CliSyntaxError (never raises on user input)."""

    def __init__(self, spec: CommandSpec, envs: Optional[EnvVars] = None):
        self.spec = spec
        self.envs = envs

    def parse(self, argv: Sequence[str]):
        # argv[0] is the program name/path and is not validated (the
        # reference parses from argv[1:] the same way).
        return self._parse(self.spec, list(argv[1:]), [], {},
                           self.spec.name_)

    def _parse(self, spec: CommandSpec, tokens: List[str],
               path: List[CommandSpec], opts: Dict[str, Any],
               full_name: str):
        options = dict(opts)
        args: Dict[str, Any] = {}
        arg_i = 0
        seen: set = set()
        args_only = False
        in_scope: Dict[str, OptionSpec] = {}
        for s in path + [spec]:
            in_scope.update(s.options_)
        while tokens:
            tok = tokens.pop(0)
            if tok == "--" and not args_only:
                args_only = True
                continue
            if not args_only and tok.startswith("--"):
                err = self._parse_long(in_scope, tok[2:], tokens, options, seen)
                if err is not None:
                    return err
                continue
            if not args_only and tok.startswith("-") and len(tok) > 1:
                err = self._parse_short(in_scope, tok[1:], tokens,
                                        options, seen)
                if err is not None:
                    return err
                continue
            # A bare token: sub-command (parent) or positional (leaf).
            if spec.is_parent():
                sub = spec.commands_.get(tok)
                if sub is None:
                    return CliSyntaxError(tok, "unknown command")
                if sub.name_ == spec._help_name:
                    # `tool help [cmd]`
                    target = tokens.pop(0) if tokens else ""
                    return self._help_for(spec, target, path)
                return self._parse(sub, tokens, path + [spec], options,
                                   full_name + "/" + sub.name_)
            if arg_i >= len(spec.args_):
                return CliSyntaxError(tok, "too many positional arguments")
            aspec = spec.args_[arg_i]
            if aspec.typ.endswith("_seq"):
                prev = args.get(aspec.name, ())
                args[aspec.name] = tuple(prev) + (tok,)
                continue          # a trailing seq arg soaks up the rest
            try:
                args[aspec.name] = aspec._convert(tok)
            except ValueError as e:
                return CliSyntaxError(tok, str(e))
            arg_i += 1

        hname = spec._help_name or self.spec._help_name
        if hname and options.get(hname):
            return CommandHelp(spec, path)
        if spec.is_parent():
            return CommandHelp(spec, path)   # parent with no sub-command

        # Env-var fallback, then defaults — over the whole spec chain
        # (ancestor options stay available under a sub-command, as the
        # reference's parser keeps parent options in scope);
        # missing required → error.
        chain_opts: Dict[str, OptionSpec] = {}
        for s in path + [spec]:
            chain_opts.update(s.options_)
        for o in chain_opts.values():
            if o.name in options:
                continue
            raw = self.envs.lookup(self.spec.name_, o.name) \
                if self.envs else None
            if raw is not None:
                try:
                    options[o.name] = o._convert(raw)
                    continue
                except ValueError as e:
                    return CliSyntaxError(raw, str(e))
            if o.typ.endswith("_seq"):
                options[o.name] = tuple(o.default or ())
            elif o.default is not None:
                options[o.name] = o.default
            elif o.required:
                return CliSyntaxError(o.name,
                                      "missing value for required option")
        for i, a in enumerate(spec.args_):
            if a.name in args:
                continue
            if a.typ.endswith("_seq"):
                args[a.name] = ()
            elif a.default is not None and not a.required:
                args[a.name] = a.default
            else:
                return CliSyntaxError(a.name,
                                      "missing value for required argument")
        return Command(spec, full_name, options, args)

    def _help_for(self, spec: CommandSpec, target: str,
                  path: List[CommandSpec]):
        if not target:
            return CommandHelp(spec, path)
        sub = spec.commands_.get(target)
        if sub is None:
            return CliSyntaxError(target, "unknown command")
        return CommandHelp(sub, path + [spec])

    def _parse_long(self, in_scope, body: str, tokens, options, seen):
        name, eq, raw = body.partition("=")
        o = in_scope.get(name)
        if o is None:
            return CliSyntaxError("--" + name, "unknown option")
        if not eq:
            if o.requires_arg():
                if not tokens:
                    return CliSyntaxError("--" + name,
                                          "missing value for option")
                raw = tokens.pop(0)
            else:
                raw = "true"
        return self._set_opt(o, raw, options, seen)

    def _parse_short(self, in_scope, body: str, tokens, options, seen):
        # -abc = -a -b -c; the last short may take a value: -n5 or -n 5.
        i = 0
        while i < len(body):
            ch = body[i]
            o = next((o for o in in_scope.values() if o.short == ch),
                     None)
            if o is None:
                return CliSyntaxError("-" + ch, "unknown short option")
            if o.requires_arg():
                raw = body[i + 1:]
                if not raw:
                    if not tokens:
                        return CliSyntaxError("-" + ch,
                                              "missing value for option")
                    raw = tokens.pop(0)
                return self._set_opt(o, raw, options, seen)
            err = self._set_opt(o, "true", options, seen)
            if err is not None:
                return err
            i += 1
        return None

    def _set_opt(self, o: OptionSpec, raw: str, options, seen):
        try:
            v = o._convert(raw)
        except ValueError as e:
            return CliSyntaxError(raw, str(e))
        if o.typ.endswith("_seq"):
            prev = options.get(o.name, ())
            options[o.name] = tuple(prev) + (v,)
        else:
            if o.name in seen:
                return CliSyntaxError("--" + o.name,
                                      "option given more than once")
            options[o.name] = v
        seen.add(o.name)
        return None
