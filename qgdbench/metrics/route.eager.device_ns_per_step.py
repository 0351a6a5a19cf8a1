"""``route.eager.device_ns_per_step`` (ns/step): device time of every other
operation of the traced window whose launch was found, launched inside a
``qgd.call`` outside both replay spans (control tables, loads and copies,
the guard sum, the terminal multiplier, the table VJP) or outside every
``qgd.*`` span (the harness's draw between calls), over the traced calls'
counted steps. An operation whose launch was not found counts in none of
the three ``route.*.device_ns_per_step``."""

from qgdbench import spans


def read(ctx):
    return spans.device_ns_per_step(ctx,
                                    lambda span: span not in spans.REPLAYS)
