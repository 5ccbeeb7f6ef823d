"""rpe_attention_roofline.geomatch (%): the rpe_attention kernel's bound for hidden states alone (no positional output) over its device time, GeoTransformer serving."""

from portbench import geotransformer_work

NAME = "rpe_attention_roofline.geomatch"
UNIT = "%"


def read(run):
    return geotransformer_work.kernel_roofline_pct(run, "rpe_attention")
