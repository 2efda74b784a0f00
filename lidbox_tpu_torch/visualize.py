"""
Visualization helpers: confusion matrices, dataset distributions,
signal/feature/embedding heatmaps, PCA scatter (counterpart of
``lidbox_tpu.visualize``; reference: lidbox/visualize.py).

Every function returns the matplotlib figure (instead of calling
plt.show()), as the JAX package's do. Tables are dicts of columns (this
port's tables) where the JAX package takes DataFrames; numpy arrays and
torch tensors plot alike. matplotlib is imported when a plot is drawn, and
seaborn, which only the two distribution plots need, when one of them is:
neither is on the card's machine.
"""
import numpy as np


def _plt():
    import matplotlib.pyplot as plt
    return plt


def _array(x):
    if hasattr(x, "detach"):  # a torch tensor
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def draw_confusion_matrix(cm, label_names, title="", cmap=None,
                          no_legend=True):
    """Row-normalized confusion matrix heatmap with per-cell annotations
    (reference: visualize.py:12-45); returns (figure, axes)."""
    plt = _plt()
    rates = _array(cm).astype(np.float64)
    n = len(label_names)
    if rates.shape != (n, n):
        raise ValueError(f"confusion matrix shape {rates.shape} must match "
                         f"{n} labels")
    rates = rates / np.maximum(rates.sum(axis=1, keepdims=True), 1e-12)
    fig, ax = plt.subplots(figsize=(4, 4))
    image = ax.imshow(rates, interpolation="nearest",
                      cmap=cmap or plt.cm.Blues)
    if not no_legend:
        fig.colorbar(image, ax=ax)
    ticks = np.arange(n)
    ax.set_xticks(ticks, labels=label_names, rotation=45, ha="right",
                  rotation_mode="anchor")
    ax.set_yticks(ticks, labels=label_names)
    # row 0 on top (true labels read downward like a table)
    ax.set_xlim(-0.5, n - 0.5)
    ax.set_ylim(n - 0.5, -0.5)
    ax.set_title(title)
    ax.set_ylabel("True label")
    ax.set_xlabel("Predicted label")
    # white text once the fill is darker than the colormap's midpoint
    midpoint = rates.max() / 2.0
    for (row, col), rate in np.ndenumerate(rates):
        ax.text(col, row, f"{rate:.2f}", ha="center", va="center",
                color="white" if rate > midpoint else "black")
    fig.tight_layout()
    return fig, ax


def _seaborn():
    try:
        import seaborn as sns
    except ImportError as e:
        raise ImportError(
            "seaborn is required for the distribution plots "
            "(plot_sample_distribution / plot_duration_distribution)") from e
    sns.set(rc={})  # the theme the JAX package sets when it imports
    return sns


def _categorical_plot_kwargs(metadata):
    """Shared seaborn kwargs: one bar group per split, colored by label,
    both in sorted order. ``metadata`` is a dict of columns (``split``,
    ``label``, ``duration``)."""
    columns = {k: list(_array(v)) if not isinstance(v, list) else v
               for k, v in metadata.items()}
    return dict(data=columns, x="split", order=sorted(set(columns["split"])),
                hue="label", hue_order=sorted(set(columns["label"])))


def plot_sample_distribution(metadata):
    """Sample counts per split/label (reference: visualize.py:60-63)."""
    sns = _seaborn()
    ax = sns.countplot(**_categorical_plot_kwargs(metadata))
    ax.set_title("Total amount of samples")
    return ax.get_figure()


def plot_duration_distribution(metadata, figsize=(8, 6)):
    """Median and total audio duration per split/label
    (reference: visualize.py:66-78)."""
    sns = _seaborn()
    plt = _plt()
    kwargs = _categorical_plot_kwargs(metadata)
    fig1, ax1 = plt.subplots(figsize=figsize)
    sns.boxplot(**kwargs, y="duration", ax=ax1)
    ax1.set_title("Median audio file duration in seconds")
    fig2, ax2 = plt.subplots(figsize=figsize)
    sns.barplot(**kwargs, y="duration", errorbar=None, estimator=np.sum,
                ax=ax2)
    ax2.set_title("Total amount of audio in seconds")
    return fig1, fig2


def plot_signal(signal, figsize=(6, 0.5), **kwargs):
    """(reference: visualize.py:81-86)"""
    fig, ax = _plt().subplots(figsize=figsize)
    ax.plot(_array(signal), lw=0.1, **kwargs)
    ax.set_axis_off()
    ax.margins(0)
    return fig


def plot_spectrogram(S, cmap="viridis", figsize=None, ax=None):
    """Feature matrix [frames, bins] as a heatmap, frequency upward
    (reference: visualize.py:89-97)."""
    S = _array(S)
    if figsize is None:
        figsize = (max(S.shape[0] / 50, 1), max(S.shape[1] / 50, 1))
    if ax is None:
        fig, ax = _plt().subplots(figsize=figsize)
    else:
        fig = ax.get_figure()
    ax.imshow(S.T, origin="lower", aspect="auto", cmap=cmap)
    ax.set_axis_off()
    ax.margins(0)
    return fig


def plot_cepstra(X, figsize=None):
    """(reference: visualize.py:99-102)"""
    X = _array(X)
    if not figsize:
        figsize = (max(X.shape[0] / 50, 1), max(X.shape[1] / 20, 1))
    return plot_spectrogram(X, cmap="RdBu_r", figsize=figsize)


def plot_embedding_vector(v, cmap="RdBu_r", figsize=None):
    """(reference: visualize.py:105-115)"""
    v = _array(v)
    if figsize is None:
        figsize = (max(v.size / 100, 1), 1)
    fig, ax = _plt().subplots(figsize=figsize)
    ax.imshow(v[None, :], aspect="auto", cmap=cmap)
    ax.set_axis_off()
    ax.margins(0)
    return fig


def draw_3d_pca_scatterplot(pca_data_3d, data_labels):
    """One 3-D scatter per label, labels in sorted order
    (reference: visualize.py:118-133); returns (figure, axes)."""
    data = _array(pca_data_3d)
    labels = np.asarray(data_labels)
    fig = _plt().figure()
    ax = fig.add_subplot(111, projection="3d")
    for label in sorted(set(labels.tolist())):
        rows = labels == label
        ax.scatter(data[rows, 0], data[rows, 1], data[rows, 2], label=label)
    ax.legend()
    return fig, ax
