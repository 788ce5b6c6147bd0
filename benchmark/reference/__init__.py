"""Plain references of what the benchmark's cells run, one module a kind,
named by a configuration's ``reference`` key.  They import nothing of the
program."""
