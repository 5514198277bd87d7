"""Analysis: parameter counts, the H100 roofline and the op counter."""
