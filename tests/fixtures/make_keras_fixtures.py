"""Write the Keras model configurations that ``chip_smoke.py`` imports.

Each fixture is ``tests/fixtures/keras/<name>.json``: ``{"model_config":
..., "training_config": ...}``, what a legacy full-model ``.h5`` holds in
its ``model_config`` and ``training_config`` attributes, with no weights
(the card's machine has neither Keras nor h5py; the smoke test draws the
weights from a seed at the shapes Keras stores). Built with the installed
Keras (``model.to_json()`` and Keras' own legacy metadata):

- ``bert_base``: BERT-base as ``tools/r4_bert_import_bench.py`` builds it
  (12 layers, 768 wide, 12 heads, FF 3072, vocab 30522, T 128, token and
  position ids, a 2-class softmax head, categorical cross-entropy);
- ``imdb_bilstm``: keras-io's "Bidirectional LSTM on IMDB" (maxlen 200,
  Embedding(20000, 128), Bidirectional(LSTM(64, return_sequences=True)),
  Bidirectional(LSTM(64)), Dense(1, sigmoid); binary cross-entropy);
- ``sequential_cnn``: keras-io's "Simple MNIST convnet" (28x28x1,
  Conv2D(32, 3) relu, MaxPooling2D(2), Conv2D(64, 3) relu,
  MaxPooling2D(2), Flatten, Dropout(0.5), Dense(10, softmax); categorical
  cross-entropy).

Run from the repository root: ``python tests/fixtures/make_keras_fixtures.py``
"""

import json
import os

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "keras")


def bert_base(keras):
    kl = keras.layers
    t, v, d, nh, ff, n_layers = 128, 30522, 768, 12, 3072, 12
    tok = kl.Input((t,), dtype="int32", name="tokens")
    pos = kl.Input((t,), dtype="int32", name="positions")
    x = kl.Add(name="embed_add")([kl.Embedding(v, d, name="tok_emb")(tok),
                                  kl.Embedding(t, d, name="pos_emb")(pos)])
    for i in range(n_layers):
        att = kl.MultiHeadAttention(num_heads=nh, key_dim=d // nh, name=f"mha_{i}")(x, x)
        x = kl.LayerNormalization(name=f"ln1_{i}")(kl.Add(name=f"add1_{i}")([x, att]))
        h = kl.Dense(ff, activation="gelu", name=f"ff1_{i}")(x)
        h = kl.Dense(d, name=f"ff2_{i}")(h)
        x = kl.LayerNormalization(name=f"ln2_{i}")(kl.Add(name=f"add2_{i}")([x, h]))
    out = kl.Dense(2, activation="softmax", name="cls")(kl.GlobalAveragePooling1D(name="pool")(x))
    return keras.Model([tok, pos], out), "categorical_crossentropy"


def imdb_bilstm(keras):
    kl = keras.layers
    # the example pads every review to maxlen 200; the importers need a
    # fixed length where the example declares (None,)
    inp = keras.Input(shape=(200,), dtype="int32")
    x = kl.Embedding(20000, 128)(inp)
    x = kl.Bidirectional(kl.LSTM(64, return_sequences=True))(x)
    x = kl.Bidirectional(kl.LSTM(64))(x)
    return keras.Model(inp, kl.Dense(1, activation="sigmoid")(x)), "binary_crossentropy"


def sequential_cnn(keras):
    kl = keras.layers
    return keras.Sequential([
        keras.Input(shape=(28, 28, 1)),
        kl.Conv2D(32, kernel_size=(3, 3), activation="relu"),
        kl.MaxPooling2D(pool_size=(2, 2)),
        kl.Conv2D(64, kernel_size=(3, 3), activation="relu"),
        kl.MaxPooling2D(pool_size=(2, 2)),
        kl.Flatten(),
        kl.Dropout(0.5),
        kl.Dense(10, activation="softmax"),
    ]), "categorical_crossentropy"


def main():
    import keras
    from keras.src.legacy.saving import saving_utils

    os.makedirs(HERE, exist_ok=True)
    for build in (bert_base, imdb_bilstm, sequential_cnn):
        model, loss = build(keras)
        model.compile(loss=loss, optimizer="adam")
        meta = saving_utils.model_metadata(model, include_optimizer=True)
        doc = {"model_config": json.loads(model.to_json()),
               "training_config": meta.get("training_config")}
        path = os.path.join(HERE, f"{build.__name__}.json")
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        print(path, model.count_params())


if __name__ == "__main__":
    main()
