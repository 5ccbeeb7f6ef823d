"""geo_embedding_roofline.geomatch (%): the geo_embedding kernel's bound at the stage-4 node counts over its device time, GeoTransformer serving."""

from portbench import geotransformer_work

NAME = "geo_embedding_roofline.geomatch"
UNIT = "%"


def read(run):
    return geotransformer_work.kernel_roofline_pct(run, "geo_embedding")
