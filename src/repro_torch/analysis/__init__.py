"""Static and runtime analysis of the port: the AST linter
(``astlint``), the exact-match baseline (``baseline``) and the contract
audit (``contracts``).  CLI: ``python -m repro_torch.analysis
{lint,audit}``."""
