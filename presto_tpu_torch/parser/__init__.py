"""SQL parser (reference: presto-parser — SqlParser.java:49 over the
ANTLR4 SqlBase.g4 grammar, 877 lines). New design: hand-written lexer +
recursive-descent/Pratt parser producing typed AST dataclasses
(reference's 171 node types in sql/tree/, built incrementally)."""

from presto_tpu_torch.parser.parser import parse_statement, ParseError
from presto_tpu_torch.parser import tree
