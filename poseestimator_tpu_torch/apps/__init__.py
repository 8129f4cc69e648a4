"""Command-line applications of the port: ``eval_bop``, the BOP scene sweep."""
