"""The plain references that decide `correct`: ed25519 (RFC 8032 over
Python ints) and the AT2 ledger rules. Neither imports the program."""
