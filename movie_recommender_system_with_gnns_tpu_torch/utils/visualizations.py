"""Visualizations: the training-history plot, the recommendation chart, the
embedding-space analysis of a user and the user-item similarity graph (JAX
package ``utils/visualizations.py``).

The module imports without matplotlib, scikit-learn, networkx or umap: each
is imported by the function that uses it, and a render function called
without matplotlib raises ``ImportError`` naming it. Figures are saved to
files with the headless Agg backend.

:func:`user_neighbourhood` is the analysis' selection, in torch on the
tables' device: the most and least similar users by cosine and the top
movies, ordered by a stable sort. Only the stack of their rows moves to the
host, for the 2-D projection (UMAP, else TSNE, else PCA by SVD). The user is
in neither list of users; JAX's ``analyze_user_recommendations`` puts it
first among the least similar (fault C7 of the reference).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch


def _pyplot(what: str):
    """matplotlib's pyplot on the Agg backend; ``ImportError`` naming
    matplotlib where it is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(f"{what} needs matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _networkx():
    try:
        import networkx
    except ImportError as e:
        raise RuntimeError("networkx is not available") from e
    return networkx


def _have_umap() -> bool:
    import importlib.util

    return importlib.util.find_spec("umap") is not None


def _as_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _embed_2d(x: np.ndarray, n_neighbors: int = 15, min_dist: float = 0.1,
              seed: int = 42) -> np.ndarray:
    """2-D projection: UMAP where installed (reference visualizations.py:150-151
    parameters), else scikit-learn's TSNE, else PCA by numpy's SVD."""
    x = np.asarray(x)
    if _have_umap():
        from umap import UMAP

        return UMAP(n_neighbors=n_neighbors, min_dist=min_dist,
                    random_state=seed).fit_transform(x)
    try:
        from sklearn.manifold import TSNE
    except ImportError:
        xc = x - x.mean(axis=0)
        _, _, vt = np.linalg.svd(xc, full_matrices=False)
        return xc @ vt[:2].T
    perp = min(30.0, max(5.0, x.shape[0] / 4.0))
    return TSNE(n_components=2, random_state=seed, perplexity=perp,
                init="pca").fit_transform(x)


def plot_histories(histories_dir: str = "data/histories",
                   out_path: Optional[str] = None):
    """Train/val loss and val recall curves with the best epoch marked
    (reference plot_histories, visualizations.py:255-294)."""
    plt = _pyplot("plot_histories")
    tl = np.load(os.path.join(histories_dir, "hist_train_loss.npy"))
    vl = np.load(os.path.join(histories_dir, "hist_val_loss.npy"))
    vr = np.load(os.path.join(histories_dir, "hist_val_recall.npy"))
    best = int(np.argmax(vr))  # visualizations.py:272

    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(9, 7), sharex=True)
    epochs = np.arange(len(tl))
    ax1.plot(epochs, tl, label="train loss", color="tab:blue")
    ax1.plot(epochs, vl, label="val loss", color="tab:orange")
    ax1.set_ylabel("BPR loss")
    ax1.legend()
    ax1.set_title("Training histories")
    ax2.plot(epochs, vr, label="val recall@k", color="tab:green")
    ax2.scatter([best], [vr[best]], color="red", zorder=5)
    ax2.annotate(f"best epoch {best}\nrecall {vr[best]:.3e}",
                 (best, vr[best]), textcoords="offset points", xytext=(10, -15))
    ax2.set_xlabel("epoch")
    ax2.set_ylabel("recall@k")
    ax2.legend()
    fig.tight_layout()
    if out_path is None:
        out_path = os.path.join(histories_dir, "histories_training.png")
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_recommendations(recommendations: List[Dict[str, Any]], user_id: int,
                         out_path: str = "recommendations.png"):
    """Horizontal bar chart of the top-k titles against their scores
    (reference plot_recommendations, visualizations.py:296-316)."""
    plt = _pyplot("plot_recommendations")
    titles = [r["title"] for r in recommendations][::-1]
    scores = [r["score"] for r in recommendations][::-1]
    fig, ax = plt.subplots(figsize=(9, 0.5 * len(titles) + 2))
    ax.barh(range(len(titles)), scores, color="tab:blue")
    ax.set_yticks(range(len(titles)))
    ax.set_yticklabels([t[:50] for t in titles], fontsize=8)
    ax.set_xlabel("score")
    ax.set_title(f"Top {len(titles)} recommendations for user {user_id}")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


class UserNeighbourhood(NamedTuple):
    """:func:`user_neighbourhood`'s selection. Indices and cosine scores are
    tensors on the tables' device, best first (the least similar users:
    least similar first); ``stack`` holds the raw rows of the user, the
    similar and dissimilar users and the top movies, on the host."""

    user_index: int
    similar: torch.Tensor
    similar_scores: torch.Tensor
    dissimilar: torch.Tensor
    dissimilar_scores: torch.Tensor
    top_movies: torch.Tensor
    movie_scores: torch.Tensor
    stack: np.ndarray


def user_neighbourhood(params, user_id: int, data, num_similar_users: int = 25,
                       num_top_movies: int = 50) -> UserNeighbourhood:
    """The users most and least similar to ``user_id`` and the movies that
    score highest for it, by cosine of the layer-0 rows, computed on the
    tables' device (reference visualizations.py:93-227). The user itself is
    in neither list. Raises ``ValueError`` for an unknown user id."""
    uidx = int(data.user_index(user_id))
    if uidx < 0:
        raise ValueError(f"Invalid user ID {user_id}")
    u, it = params.user_emb.detach(), params.item_emb.detach()
    un = u / torch.linalg.vector_norm(u, dim=1, keepdim=True)
    itn = it / torch.linalg.vector_norm(it, dim=1, keepdim=True)
    me = un[uidx]
    sims = un @ me
    me_idx = torch.tensor([uidx], device=u.device)
    k = min(num_similar_users, u.shape[0] - 1)
    sim_s, sim_i = torch.sort(sims.index_fill(0, me_idx, -torch.inf),
                              descending=True, stable=True)
    dis_s, dis_i = torch.sort(sims.index_fill(0, me_idx, torch.inf), stable=True)
    mov_s, mov_i = torch.sort(itn @ me, descending=True, stable=True)
    sim_s, sim_i, dis_s, dis_i = sim_s[:k], sim_i[:k], dis_s[:k], dis_i[:k]
    mov_s, mov_i = mov_s[:num_top_movies], mov_i[:num_top_movies]
    stack = torch.cat([u[uidx][None], u[sim_i], u[dis_i], it[mov_i]]).cpu().numpy()
    return UserNeighbourhood(uidx, sim_i, sim_s, dis_i, dis_s, mov_i, mov_s, stack)


def analyze_user_recommendations(
    params,
    user_id: int,
    data,
    n_neighbors: int = 15,
    min_dist: float = 0.1,
    out_path: str = "user_analysis.png",
    num_similar_users: int = 25,
    num_top_movies: int = 50,
):
    """2-D embedding-space analysis of a user (reference
    analyze_user_recommendations, visualizations.py:93-227): the
    :func:`user_neighbourhood` selection, projected together and
    scatter-plotted by type."""
    hood = user_neighbourhood(params, user_id, data, num_similar_users, num_top_movies)
    return _render_analysis(hood, user_id, n_neighbors, min_dist, out_path)


def _render_analysis(hood: UserNeighbourhood, user_id: int, n_neighbors: int = 15,
                     min_dist: float = 0.1, out_path: str = "user_analysis.png"):
    """The host half of :func:`analyze_user_recommendations`: ``hood.stack``
    projected to 2-D and scatter-plotted by type into ``out_path``."""
    plt = _pyplot("analyze_user_recommendations")
    xy = _embed_2d(hood.stack, n_neighbors=n_neighbors, min_dist=min_dist)

    fig, ax = plt.subplots(figsize=(9, 7))
    s = 1 + len(hood.similar)
    d = s + len(hood.dissimilar)
    ax.scatter(*xy[1:s].T, c="tab:green", marker="o", label="similar users", alpha=0.7)
    ax.scatter(*xy[s:d].T, c="tab:red", marker="o", label="dissimilar users", alpha=0.7)
    ax.scatter(*xy[d:].T, c="tab:blue", marker="^", label="recommended movies", alpha=0.7)
    ax.scatter(*xy[0].T, c="black", marker="*", s=250, label=f"user {user_id}")
    ax.legend()
    ax.set_title(f"Embedding-space neighborhood of user {user_id} "
                 f"({'UMAP' if _have_umap() else 'TSNE/PCA'})")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def create_user_item_graph(user_embedding, item_embedding, num_users: int = 100,
                           num_items: int = 100, top_k: int = 5):
    """Bipartite similarity graph: each of the first ``num_users`` users links
    to its ``top_k`` highest-scored items among the first ``num_items``
    (reference create_user_item_graph, visualizations.py:21-38). Takes
    tensors or arrays; raises ``RuntimeError`` without networkx."""
    nx = _networkx()
    u = _as_numpy(user_embedding)[:num_users]
    it = _as_numpy(item_embedding)[:num_items]
    g = nx.Graph()
    for i in range(u.shape[0]):
        g.add_node(f"U{i}", bipartite=0)
    for i in range(it.shape[0]):
        g.add_node(f"I{i}", bipartite=1)
    top = np.argsort(-(u @ it.T), axis=1, kind="stable")[:, :top_k]
    for i in range(u.shape[0]):
        for j in top[i]:
            g.add_edge(f"U{i}", f"I{int(j)}")
    return g


def plot_user_item_graph(g, out_path: str = "user_item_graph.png"):
    """Spring-layout render (reference plot_user_item_graph,
    visualizations.py:40-91)."""
    nx = _networkx()
    plt = _pyplot("plot_user_item_graph")
    pos = nx.spring_layout(g, seed=42)
    fig, ax = plt.subplots(figsize=(9, 9))
    colors = ["tab:blue" if n.startswith("U") else "tab:orange" for n in g.nodes()]
    nx.draw_networkx_edges(g, pos, ax=ax, width=0.5, edge_color="#888888")
    nx.draw_networkx_nodes(g, pos, ax=ax, node_size=30, node_color=colors)
    ax.set_title("User-Item Interaction Graph")
    ax.axis("off")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
