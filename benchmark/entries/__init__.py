"""The entries a traffic mix can name ("entry"): each drives one entry of
the program with `measure(ctx)` and follows it with the reference in
`check(ctx, measured)`."""
