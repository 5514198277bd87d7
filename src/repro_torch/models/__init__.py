"""Model families of the port (the paper's BLSTM acoustic model so far)."""
