"""The paper's two SNN configurations.

  impulse-imdb : input 100 (GloVe-100d spike encoder) -> FC128 -> FC128 -> 1,
                 RMP neurons, 6b W / 11b V_MEM, 10 timesteps. 29.3K params.
  impulse-mnist: modified LeNet-5 with fan-in <= 128 (14 channels, 3x3
                 kernels => 3*3*14 = 126 <= 128), FC layers < 128 neurons.
"""
from dataclasses import dataclass, field

from repro_torch.configs.base import SpikingConfig


@dataclass(frozen=True)
class SNNModelConfig:
    arch_id: str
    layer_sizes: tuple            # FC sizes, input first
    conv_spec: tuple = ()         # ((out_ch, k, stride), ...) before FC stack
    in_shape: tuple = ()          # conv input (H, W, C)
    spiking: SpikingConfig = field(default_factory=SpikingConfig)
    timesteps: int = 10
    task: str = "binary"          # binary | multiclass


IMDB = SNNModelConfig(
    arch_id="impulse-imdb",
    layer_sizes=(100, 128, 128, 1),
    spiking=SpikingConfig(neuron="rmp", timesteps=10, threshold=1.0,
                          leak=0.0625, w_bits=6, v_bits=11),
    timesteps=10,
    task="binary",
)

# Modified LeNet-5: Conv1 is the spike encoder (off-macro, like the paper's
# input layer); Conv2, Conv3 and the FCs map onto the macros. Channel counts
# keep the fan-in at 3*3*14 = 126 <= 128 and every FC below 128 neurons.
MNIST = SNNModelConfig(
    arch_id="impulse-mnist",
    conv_spec=((14, 3, 1), (14, 3, 2), (14, 3, 2)),   # encoder + 2 macro convs
    in_shape=(28, 28, 1),
    layer_sizes=(686, 120, 84, 10),                   # 7*7*14 = 686 flatten
    spiking=SpikingConfig(neuron="rmp", timesteps=10, threshold=1.0,
                          leak=0.0625, w_bits=6, v_bits=11),
    timesteps=10,
    task="multiclass",
)

SNN_CONFIGS = {c.arch_id: c for c in (IMDB, MNIST)}


def get_snn_config(arch_id: str) -> SNNModelConfig:
    """The registered configuration named ``arch_id``."""
    return SNN_CONFIGS[arch_id]
