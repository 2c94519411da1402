"""Command-line SQL console (reference: presto_tpu/cli.py; presto-cli
Console.java:68 in Presto).

  python -m presto_tpu_torch.cli --execute "select 1"      # in-process
  python -m presto_tpu_torch.cli --mesh 8 --execute "..."  # mesh runner
  python -m presto_tpu_torch.cli --server http://host:port \\
      --execute "..."                                      # a coordinator
  python -m presto_tpu_torch.cli                           # REPL

In-process runs go on CUDA unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import sys


def _format_value(v, typ) -> str:
    if v is None:
        return "NULL"
    if typ == "date" and isinstance(v, int):
        from presto_tpu_torch.expr.dates import days_to_date
        return days_to_date(v).isoformat()
    return str(v)


def format_rows(names, rows, types=None) -> str:
    cols = [str(n) for n in names]
    types = types or [None] * len(cols)
    table = [[_format_value(v, t) for v, t in zip(r, types)] for r in rows]
    widths = [len(c) for c in cols]
    for r in table:
        for i, v in enumerate(r):
            widths[i] = max(widths[i], len(v))

    def fmt(vals):
        return " | ".join(v.ljust(w) for v, w in zip(vals, widths))

    lines = [fmt(cols), "-+-".join("-" * w for w in widths)]
    lines += [fmt(r) for r in table]
    lines.append(f"({len(table)} row{'s' if len(table) != 1 else ''})")
    return "\n".join(lines)


def _run_one(sql: str, args, runner) -> int:
    try:
        if args.server:
            from presto_tpu_torch.server.coordinator import StatementClient
            columns, data = StatementClient(args.server).execute(sql)
            print(format_rows([c["name"] for c in columns], data,
                              [c.get("type") for c in columns]))
        else:
            res = runner.execute(sql)
            print(format_rows(res.names, res.rows(),
                              [f.type.name for f in res.fields]))
        return 0
    except Exception as e:  # noqa: BLE001 — the console's surface
        print(f"error: {e}", file=sys.stderr)
        return 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="presto_tpu_torch.cli")
    p.add_argument("--execute", "-e", help="run one statement and exit")
    p.add_argument("--server", help="coordinator URL (client protocol)")
    p.add_argument("--catalog", default="tpch")
    p.add_argument("--schema", default="tiny")
    p.add_argument("--mesh", type=int, default=0,
                   help="run distributed over N workers on one card")
    p.add_argument("--device", default=None,
                   help="torch device of an in-process run (default "
                        "CUDA)")
    args = p.parse_args(argv)

    runner = None
    if not args.server:
        if args.mesh:
            from presto_tpu_torch.runner import MeshRunner
            runner = MeshRunner(args.catalog, args.schema,
                                n_workers=args.mesh, device=args.device)
        else:
            from presto_tpu_torch.runner import LocalRunner
            runner = LocalRunner(args.catalog, args.schema,
                                 device=args.device)

    if args.execute:
        return _run_one(args.execute, args, runner)

    buf = []
    while True:
        try:
            line = input("presto> " if not buf else "     -> ")
        except EOFError:
            return 0
        buf.append(line)
        if line.rstrip().endswith(";") or line.strip() == "":
            sql = "\n".join(buf).strip().rstrip(";")
            buf = []
            if sql in ("quit", "exit"):
                return 0
            if sql:
                _run_one(sql, args, runner)


if __name__ == "__main__":
    sys.exit(main())
