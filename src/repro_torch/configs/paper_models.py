"""The paper's OWN model zoo (§4.2) for the faithful FL reproduction.

"We use logistic regression for synthetic and MNIST, Convolution Neural
Network for FEMNIST, and LSTM classifier for Shakespeare. ... 2-layer CNN
with a hidden size of 64 and 1-layer LSTM with a hidden size of 256."
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class PaperNetConfig:
    name: str
    kind: str                 # logreg | cnn | lstm
    input_dim: int = 0        # logreg feature dim
    num_classes: int = 10
    image_size: int = 28      # cnn
    channels: int = 1
    hidden: int = 64          # cnn hidden / lstm hidden
    vocab: int = 0            # lstm char vocab
    seq_len: int = 0          # lstm sequence length
    embed_dim: int = 8


LOGREG_SYN = PaperNetConfig(name="logreg-syn", kind="logreg", input_dim=60, num_classes=10)
LOGREG_MNIST = PaperNetConfig(name="logreg-mnist", kind="logreg", input_dim=784, num_classes=10)
CNN_FEMNIST = PaperNetConfig(name="cnn-femnist", kind="cnn", image_size=28, channels=1,
                             hidden=64, num_classes=62)
LSTM_SHAKES = PaperNetConfig(name="lstm-shakespeare", kind="lstm", vocab=80, seq_len=80,
                             hidden=256, num_classes=80, embed_dim=8)

PAPER_NETS = {c.name: c for c in (LOGREG_SYN, LOGREG_MNIST, CNN_FEMNIST, LSTM_SHAKES)}
