"""roitr_torch.viz: figures of dumped pairs (visualizer.py) and of the
descriptors' feature space (feature_space.py), as roitr_tpu/viz/ draws
them. matplotlib and scikit-learn are imported only when a figure is
drawn."""

from roitr_torch.viz.feature_space import visualize_feature_space  # noqa: F401
from roitr_torch.viz.visualizer import Visualizer  # noqa: F401
